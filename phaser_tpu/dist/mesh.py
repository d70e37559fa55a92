"""Genomic sharding over a jax.sharding.Mesh.

The reference's parallelism is a fork pool over contigs with parent-side
merges (/root/reference/phaser/phaser.py:2077-2094, 558-586).  Here the
data-parallel axis is genomic: read batches shard along axis "reads" of a
device mesh; per-shard count tensors merge with psum — the collective runs
over NVLink (NCCL) across the GPUs of one host, and the same program runs on
the xla_force_host_platform_device_count virtual mesh in tests/dry runs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "reads") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_reads(mesh: Mesh, *arrays, axis_name: str = "reads"):
    """Place (N, ...) read-major arrays row-sharded across the mesh.
    N must be divisible by the mesh size (callers pad)."""
    sh = NamedSharding(mesh, P(axis_name))
    return tuple(jax.device_put(a, sh) for a in arrays)


def pad_to_multiple(a: np.ndarray, mult: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    n = a.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


def sharded_phasing_step(mesh: Mesh, codes, quals, refpos, vpos, ind_codes,
                         n_ind, baseq: int, band: int = 8,
                         score_block: int = 8,
                         cc_threshold: float = 0.01):
    """One full sharded pipeline step, dryrun/compile target for the driver:

      per shard: allele assignment -> per-(variant, allele-class) counts and
      BANDED pair-configuration counts (variant pairs within `band` table
      entries — connections are bounded by fragment span, so the pair tensor
      is a dense (M, band, 9) band, psum-able across the mesh exactly like
      the reference's pool merges) -> psum -> ON-DEVICE #3: global noise
      estimate from the merged counts + banded connection tests + pruning
      (kernels.stats — counts never leave HBM) -> batched 2^(K-1)
      phase-config scoring as one matmul for the first `score_block`-variant
      window.

    Returns (allele_counts (M,3), pair_band (M,band,9),
             prune (M,band) bool, scores (2^(K-1),)).
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    from ..kernels.alleles import assign_alleles_device
    from ..kernels.phasescore import enumerate_scores

    n_vars = int(vpos.shape[0])

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("reads"), P("reads"), P("reads"), P(), P(), P()),
        out_specs=(P(), P()))
    def step(codes, quals, refpos, vpos, ind_codes, n_ind):
        vidx, allele = assign_alleles_device(codes, quals, refpos, vpos,
                                             ind_codes, n_ind, baseq)
        hit = allele < 3
        flat_v = jnp.where(hit, vidx, 0)
        flat_a = jnp.where(hit, allele, 0)
        counts = jnp.zeros((n_vars, 3), jnp.int32)
        counts = counts.at[flat_v.reshape(-1), flat_a.reshape(-1)].add(
            hit.reshape(-1).astype(jnp.int32))
        # banded within-read pair counts: for each read row, all hit pairs
        # (l1 < l2) whose variant indices differ by 1..band
        N, L = vidx.shape
        pair = jnp.zeros((n_vars, band, 9), jnp.int32)
        vi = vidx[:, :, None]          # (N, L, 1)
        vj = vidx[:, None, :]          # (N, 1, L)
        ai = allele[:, :, None]
        aj = allele[:, None, :]
        d = vj - vi
        ok = (ai < 3) & (aj < 3) & (d >= 1) & (d <= band)
        band_i = jnp.where(ok, vi, 0).reshape(-1)
        band_d = jnp.where(ok, d - 1, 0).reshape(-1)
        cfg = jnp.where(ok, ai * 3 + aj, 0).reshape(-1)
        pair = pair.at[band_i, band_d, cfg].add(ok.reshape(-1).astype(jnp.int32))
        return (jax.lax.psum(counts, "reads"), jax.lax.psum(pair, "reads"))

    counts, pair = step(codes, quals, refpos, vpos, ind_codes, n_ind)

    # ---- on-device #3: noise + connection tests on the merged tensors
    # (replicated post-psum, so this runs without further collectives)
    from ..kernels.stats import noise_from_counts, prune_mask

    noise_e = noise_from_counts(counts)
    cfg_a = pair[:, :, 0] + pair[:, :, 4]          # cis support
    cfg_b = pair[:, :, 1] + pair[:, :, 3]          # trans support
    other = (pair[:, :, 2] + pair[:, :, 5] + pair[:, :, 6] +
             pair[:, :, 7] + pair[:, :, 8])
    _, prune, _ = prune_mask(cfg_a.astype(jnp.float32),
                             cfg_b.astype(jnp.float32),
                             other.astype(jnp.float32), noise_e,
                             cc_threshold)

    # phase-config scoring for the first score_block variants: derive a
    # cis-support allele adjacency from the globally-merged band and score
    # every complement class (__graft_entry__ recomputes this construction
    # on the host and asserts the scores value-for-value)
    K = score_block
    M = jnp.zeros((2 * K, 2 * K), jnp.float32)
    for dd in range(min(band, K - 1)):
        cis = (pair[:K - dd - 1, dd, 0] + pair[:K - dd - 1, dd, 4]) > 0
        for i in range(K - dd - 1):
            j = i + dd + 1
            M = M.at[i * 2, j * 2].set(cis[i].astype(jnp.float32))
            M = M.at[j * 2, i * 2].set(cis[i].astype(jnp.float32))
            M = M.at[i * 2 + 1, j * 2 + 1].set(cis[i].astype(jnp.float32))
            M = M.at[j * 2 + 1, i * 2 + 1].set(cis[i].astype(jnp.float32))
    scores = enumerate_scores(M, K)
    return counts, pair, prune, scores


def sharded_allele_counts(mesh: Mesh, codes, quals, refpos, vpos, ind_codes,
                          n_ind, baseq: int):
    """Full sharded hot path: per-device allele assignment + psum'd
    per-(variant, allele-class) count tensor. Returns (n_vars, 3) counts.

    This is the merge semantics of phaser.py:558-586 as one reduction.
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    from ..kernels.alleles import assign_alleles_device

    n_vars = int(vpos.shape[0])

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("reads"), P("reads"), P("reads"), P(), P(), P()),
        out_specs=P())
    def step(codes, quals, refpos, vpos, ind_codes, n_ind):
        vidx, allele = assign_alleles_device(codes, quals, refpos, vpos,
                                             ind_codes, n_ind, baseq)
        hit = allele < 3
        flat_v = jnp.where(hit, vidx, 0).reshape(-1)
        flat_a = jnp.where(hit, allele, 0).reshape(-1)
        local = jnp.zeros((n_vars, 3), jnp.int32)
        local = local.at[flat_v, flat_a].add(hit.reshape(-1).astype(jnp.int32))
        return jax.lax.psum(local, "reads")

    return step(codes, quals, refpos, vpos, ind_codes, n_ind)
