"""Multi-host execution scaffolding.

The reference is strictly single-node (fork pool + temp files, SURVEY §2.4).
The phaser_tpu equivalent per that survey: a JAX global runtime with
collectives within a host and across hosts —

  1. `initialize()` -> jax.distributed.initialize (env- or flag-driven)
  2. each host decodes its own BAM shard (reads partitioned by position
     range, halo-extended so read PAIRS spanning a shard boundary land on
     both owners and dedupe by uid downstream)
  3. `global_read_tensors()` assembles process-local (N, L) tensors into
     globally-sharded arrays via jax.make_array_from_process_local_data
  4. the same `sharded_phasing_step` program runs over the global mesh;
     count-tensor psums ride the collective backend (Gloo on CPU)

Single-chip environments exercise everything below through the virtual CPU
mesh (tests + the virtual-mesh dryrun); several real hosts only change
`initialize()` arguments.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env fallbacks; no-op when single."""
    import jax
    if num_processes is None:
        num_processes = int(os.environ.get("PHASER_TPU_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("PHASER_TPU_COORDINATOR", "localhost:9701"),
        num_processes=num_processes,
        process_id=process_id
        if process_id is not None
        else int(os.environ.get("PHASER_TPU_PROCESS_ID", "0")))


def position_shards(contig_length: int, n_shards: int,
                    halo: int = 1000) -> Sequence[Tuple[int, int]]:
    """Half-open position ranges per shard, halo-extended on the right so
    fragments spanning a boundary are fully visible to the left owner.
    A read is OWNED by the shard containing its leftmost position; hits are
    deduplicated by read uid when merged, so the halo introduces no double
    counting."""
    step = -(-contig_length // n_shards)
    out = []
    for i in range(n_shards):
        lo = i * step
        hi = min((i + 1) * step + halo, contig_length)
        out.append((lo, hi))
    return out


def local_read_selection(bd, shard: Tuple[int, int]) -> np.ndarray:
    """Indices of reads owned by this host's position shard."""
    lo, hi = shard
    pos = bd.pos.astype(np.int64)
    return np.flatnonzero((pos >= lo) & (pos < hi))


def global_read_tensors(mesh, codes: np.ndarray, quals: np.ndarray,
                        refpos: np.ndarray, axis: str = "reads"):
    """Assemble process-local read tensors into globally-sharded arrays.

    On a single process this is equivalent to device_put with a row
    sharding; across processes each host contributes its local batch and
    the global array spans all of them.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    n_proc = jax.process_count()
    out = []
    for local in (codes, quals, refpos):
        global_shape = (local.shape[0] * n_proc,) + local.shape[1:]
        out.append(jax.make_array_from_process_local_data(
            sharding, local, global_shape))
    return tuple(out)


def run_sharded_step(mesh, codes, quals, refpos, vpos, ind_codes, n_ind,
                     baseq: int):
    """Global-array version of the sharded pipeline step."""
    from .mesh import sharded_phasing_step

    g_codes, g_quals, g_refpos = global_read_tensors(mesh, codes, quals,
                                                     refpos)
    return sharded_phasing_step(mesh, g_codes, g_quals, g_refpos, vpos,
                                ind_codes, n_ind, baseq)


def multiprocess_allele_counts(bam: str, vcf: str, sample: str,
                               num_processes: int, process_id: int,
                               coordinator: str = "localhost:9701",
                               baseq: int = 10, mapq: int = 10,
                               platform: str = "cpu",
                               contig: str = "") -> np.ndarray:
    """True multi-process hot path: every process owns one position shard
    of the reads, packs its local tensors, and the per-(variant, allele)
    count tensor merges with a cross-process psum (Gloo on CPU). Returns the fully-replicated (n_vars, 3) counts.

    Demonstrates the SURVEY §2.4 mapping end-to-end: genomic shards as the
    mesh axis, jax.make_array_from_process_local_data for per-host ingest,
    collective merges instead of fork-pool parent merges.
    """
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    if num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    from jax.experimental import multihost_utils
    from ..io import bam as bamio
    from ..io import vcf as vcfio
    from ..engine.varmap import build_variant_table
    from ..kernels.alleles import pack_reads
    from .mesh import make_mesh, sharded_allele_counts

    # variant table for the (first) contig
    sample_column = vcfio.sample_column_map(vcf)[sample]
    filtered = [l for l in vcfio.het_filtered_lines(vcf, sample_column,
                                                    contig or None, None)
                if not l.startswith("#")]
    hs = vcfio.parse_het_sites(filtered, contig, ["_", ":"], True)
    c = next(iter(hs.pool))
    vt = build_variant_table(c, hs.pool[c])
    pos = vt.pos.astype(np.int32)
    # exclude BOTH sides of duplicate-position entries, matching the engine's
    # device-table rule (mapper.dispatch: duplicates resolve on the host)
    if len(pos):
        dup = np.zeros(len(pos), bool)
        d = np.diff(pos) == 0
        dup[1:] |= d
        dup[:-1] |= d
        keep = ~dup
    else:
        keep = np.zeros(0, bool)
    vpos, ind, ni = pos[keep], vt.ind_codes[keep], vt.n_ind[keep]

    # this process decodes + owns one position shard of the reads
    bd = bamio.read_bam(bam)
    span = int(bd.pos.max()) + 1 if len(bd) else 1
    shard = position_shards(span, num_processes, halo=0)[process_id]
    hi = shard[1] if process_id < num_processes - 1 else span
    mask = np.zeros(len(bd), bool)
    mask[local_read_selection(bd, (shard[0], hi))] = True
    local = bd.select(mask)
    codes, quals, refpos = pack_reads(local, max_len=1)

    # agree on global padded (rows, L) so every shard is the same shape
    dims = multihost_utils.process_allgather(
        np.array([codes.shape[0], codes.shape[1]], np.int64))
    dims = dims.reshape(-1, 2)
    n_pad, l_pad = int(dims[:, 0].max()), int(dims[:, 1].max())

    def _pad(a, fill=0):
        out = np.full((n_pad, l_pad), fill, a.dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    mesh = make_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("reads"))
    n_total = n_pad * num_processes
    g = [jax.make_array_from_process_local_data(sh, _pad(a),
                                                (n_total, l_pad))
         for a in (codes, quals, refpos)]
    counts = sharded_allele_counts(mesh, g[0], g[1], g[2],
                                   jax.numpy.asarray(vpos),
                                   jax.numpy.asarray(ind),
                                   jax.numpy.asarray(ni), baseq)
    return np.asarray(counts)


def _mp_main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(prog="phaser_tpu.dist.multihost")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--vcf", required=True)
    ap.add_argument("--sample", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:9701")
    ap.add_argument("--baseq", type=int, default=10)
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--contig", default="")
    ap.add_argument("--o", default="")
    args = ap.parse_args(argv)
    counts = multiprocess_allele_counts(
        args.bam, args.vcf, args.sample, args.num_processes,
        args.process_id, coordinator=args.coordinator, baseq=args.baseq,
        platform=args.platform, contig=args.contig)
    if args.process_id == 0:
        payload = json.dumps({"n_vars": int(counts.shape[0]),
                              "total_hits": int(counts.sum()),
                              "counts": counts.tolist()})
        if args.o:
            with open(args.o, "w") as f:
                f.write(payload + "\n")
        print("MULTIHOST_RESULT " + payload)
    return 0


if __name__ == "__main__":
    import sys as _sys
    _sys.exit(_mp_main())
