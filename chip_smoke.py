#!/usr/bin/env python3
"""Smoke run of phaser_tpu's main path on one NVIDIA GPU, in one process.

Run from the root of a checkout, on a machine with a GPU:

    python3 chip_smoke.py [--seed 0]

Phases (each prints its own lines; a failure in any of them exits non-zero
and the last line is never printed):

  1. device   JAX's platform must be `gpu`; prints the devices, the card's
              name and power limit (nvidia-smi) and the JAX version; the
              native IO library must have loaded.
  2. fixture  one sample's paired RNA-seq BAM + het VCF made from --seed
              (tests/datagen.py): 1M input reads over three contigs holding
              60/25/15% of them, error rate 0.01, with spliced, deletion and
              insertion reads, so every device format and the host
              remainder carry load.
  3. engine   the phasing CLI in-process, --device gpu three times (cold
              compile; recompile at the hit capacities learned by the first
              run; steady state) and --device host; every output file must
              be byte-identical (the phased VCF compared gunzipped) and no
              device launch may fall back to the host.
  4. kernels  each device kernel at real widths against its plain reference:
              the affine-nibble, delta-nibble and refpos-plane classifiers
              (262,144-row launches, 100,000-site table) against the host
              mapper, with their steady-state times; pair counting and
              connected components against the engine's host paths; 2^n
              phase scoring (n = 16..20) against the host matmul; binomial
              prune decisions against SciPy; the cis-var bootstrap at
              bs = 10,000 against NumPy resampling.

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# one sample's RNA-seq run at chr22 scale (BASELINE.json config 1)
N_READS = 1_000_000
CONTIG_SHARES = (0.6, 0.25, 0.15)
# classifier launch shape: mapper.dispatch._SUB_ROWS reads against a
# whole-chromosome het table
KERNEL_ROWS = 1 << 18
KERNEL_SITES = 100_000
KERNEL_READ_LEN = 100
KERNEL_CONTIG_LEN = 50_000_000

OUTPUT_SUFFIXES = ("haplotypes.txt", "haplotypic_counts.txt",
                   "allelic_counts.txt", "variant_connections.txt",
                   "allele_config.txt", "vcf.gz")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _read_output(path: str) -> bytes:
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if path.endswith(".gz") else raw


def compare_outputs(prefix_a: str, prefix_b: str) -> list:
    """Output files of two runs that differ (or exist on one side only)."""
    bad = []
    for sfx in OUTPUT_SUFFIXES:
        a, b = prefix_a + "." + sfx, prefix_b + "." + sfx
        if not (os.path.isfile(a) and os.path.isfile(b)):
            bad.append(sfx)
        elif _read_output(a) != _read_output(b):
            bad.append(sfx)
    return bad


# ---------------------------------------------------------------------------
# 1. device

def check_device():
    """(device, card) — card is nvidia-smi's 'name, power.limit' line."""
    import jax
    devs = jax.devices()
    dev = devs[0]
    print("device: jax %s, devices %s, kind %r"
          % (jax.__version__, devs, dev.device_kind))
    check(dev.platform == "gpu",
          "JAX's default platform is %r, not gpu" % dev.platform)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          "nvidia-smi failed: %s" % smi.stderr.strip())
    card = smi.stdout.strip().splitlines()[0].strip()
    print("card: %s" % card)
    from phaser_tpu.io import native
    check(native.get_lib() is not None,
          "native IO library did not load (the run would time the Python "
          "codecs)")
    print("device: native IO library loaded")
    return dev, card


# ---------------------------------------------------------------------------
# 2. fixture

def make_fixture(workdir: str, seed: int, n_reads: int):
    import datagen
    pairs = [int(n_reads // 2 * s) for s in CONTIG_SHARES]
    lens = [max(250_000, p * 12) for p in pairs]
    nvar = [max(100, p // 40) for p in pairs]
    t0 = time.perf_counter()
    vcf, bam, data = datagen.write_fixture_dir(
        workdir, seed=seed, contigs=("chr1", "chr2", "chr3"),
        contig_len=lens, n_variants_per_contig=nvar,
        n_reads_per_contig=pairs, error_rate=0.01)
    dt = time.perf_counter() - t0
    n_in = len(data.bam_records)
    print("fixture: %d input reads, %d variants, contigs %s, made in %.3f s"
          % (n_in, len(data.variants), dict(zip(data.contigs, lens)), dt))
    return vcf, bam, data.sample, n_in


# ---------------------------------------------------------------------------
# 3. engine

def run_engine(vcf: str, bam: str, sample: str, n_reads: int, workdir: str,
               card: str, device: str = "gpu") -> float:
    """Runs the CLI with `device` (cold, relearn, steady) and host; returns
    the steady device-run wall seconds."""
    from phaser_tpu.cli.phaser_main import main as phaser_main
    from phaser_tpu.utils import trace

    def one(tag: str, dev: str):
        prefix = os.path.join(workdir, tag)
        argv = ["--vcf", vcf, "--bam", bam, "--sample", sample,
                # fixture MAPQs are {10, 30, 60, 255}: 10 keeps every read
                "--mapq", "10", "--baseq", "10", "--paired_end", "1",
                "--o", prefix, "--device", dev]
        d0, f0 = trace.device_seconds(), trace.device_fallbacks()
        t0 = time.perf_counter()
        rc = phaser_main(argv)
        wall = time.perf_counter() - t0
        dev_s = trace.device_seconds() - d0
        fb = trace.device_fallbacks() - f0
        check(rc == 0, "phaser_main --device %s exited %d" % (dev, rc))
        print("engine: --device %s (%s) wall %.3f s, %.1f reads/s, "
              "device-path %.3f s (host clock), fallbacks %d [%s]"
              % (dev, tag, wall, n_reads / wall, dev_s, fb, card))
        check(fb == 0, "%d device launches fell back to the host" % fb)
        return prefix, wall

    runs = [one(tag, device)[0] for tag in ("device_cold", "device_relearn")]
    steady, wall = one("device_steady", device)
    host, _ = one("host", "host")
    for prefix in runs + [steady]:
        bad = compare_outputs(prefix, host)
        check(not bad, "device and host outputs differ: %s" % bad)
    print("engine: --device %s and --device host outputs byte-identical "
          "(%s)" % (device, ", ".join(OUTPUT_SUFFIXES)))
    return wall


# ---------------------------------------------------------------------------
# 4. kernels

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _synth_table(rng, n_sites: int, contig_len: int):
    from phaser_tpu.engine.varmap import build_variant_table
    pos = np.sort(rng.choice(np.arange(1000, contig_len - 1000),
                             n_sites, replace=False))
    bases = np.array(list("ACGT"))
    ref = rng.integers(0, 4, n_sites)
    alt = (ref + rng.integers(1, 4, n_sites)) % 4
    recs = [["chrS", str(int(p)), "rs%d" % i, bases[r], bases[a], "100",
             "PASS", "AF=0.5", "GT", "0|1", ["0", "1"]]
            for i, (p, r, a) in enumerate(zip(pos, ref, alt))]
    return build_variant_table("chrS", recs)


def _synth_reads(rng, n: int, L: int, kind: str, contig_len: int):
    """n coordinate-sorted reads of length L: 'affine' (LM), 'delta'
    (hM dD rM, deletion) or 'plane' (hM gN rM, spliced)."""
    from phaser_tpu.io.bam import BamData, NameView, OP_D, OP_M, OP_N
    pos = np.sort(rng.integers(0, contig_len - 2 * L - 1000, n)).astype(
        np.int32)
    if kind == "affine":
        cig = np.full((n, 1), (L << 4) | OP_M, np.uint32)
    else:
        head = rng.integers(10, L - 10, n).astype(np.uint32)
        gap = (rng.integers(1, 30, n) if kind == "delta"
               else rng.integers(50, 800, n)).astype(np.uint32)
        op = OP_D if kind == "delta" else OP_N
        cig = np.stack([(head << 4) | OP_M, (gap << 4) | op,
                        ((L - head) << 4) | OP_M], axis=1)
    codes = np.array([1, 2, 4, 8], np.uint8)[rng.integers(0, 4, n * L)]
    quals = rng.integers(2, 41, n * L).astype(np.uint8)
    off = np.arange(n + 1, dtype=np.int64)
    return BamData(
        ref_names=["chrS"], ref_lengths=[contig_len], header_text="",
        refid=np.zeros(n, np.int32), pos=pos,
        mapq=np.full(n, 60, np.uint8), flag=np.zeros(n, np.uint16),
        tlen=np.zeros(n, np.int32), as_score=np.zeros(n, np.int32),
        has_as=np.zeros(n, bool), names=NameView(b"", np.zeros(n + 1,
                                                               np.int64)),
        cigar_flat=cig.reshape(-1), cigar_off=off * cig.shape[1],
        seq_flat=codes, qual_flat=quals, seq_off=off * L)


def _timed(step, reps: int = 10):
    """Steady-state seconds per launch: warm, `reps` launches, then a wait
    and a fetch of the last result."""
    import jax
    jax.block_until_ready(step())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step()
    jax.block_until_ready(out)
    per_launch = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    fetched = np.asarray(out)
    return per_launch, time.perf_counter() - t0, fetched


def check_classifiers(rng, card: str, rows: int = KERNEL_ROWS,
                      sites: int = KERNEL_SITES,
                      read_len: int = KERNEL_READ_LEN,
                      contig_len: int = KERNEL_CONTIG_LEN) -> dict:
    """Each allele-classification format vs the host mapper; returns
    {format: seconds per launch}."""
    import jax.numpy as jnp
    from phaser_tpu.engine.hits import classify_alleles
    from phaser_tpu.kernels import alleles as K
    from phaser_tpu.mapper.host import assign_alleles

    vt = _synth_table(rng, sites, contig_len)
    M = len(vt)
    Mp = _next_pow2(M)
    vpos = np.full(Mp, np.iinfo(np.int32).max, np.int32)
    vpos[:M] = vt.pos
    ind = np.zeros((Mp, 2), np.uint8)
    ind[:M] = vt.ind_codes
    ni = np.zeros(Mp, np.int8)
    ni[:M] = vt.n_ind
    jv, ji, jn = jnp.asarray(vpos), jnp.asarray(ind), jnp.asarray(ni)
    times = {}
    for kind in ("affine", "delta", "plane"):
        bd = _synth_reads(rng, rows, read_len, kind, contig_len)
        if kind == "affine":
            nc, aff, st, lo, hi = K.pack_affine_nibble(bd, 10)
            check(bool(aff.all()), "affine packer rejected affine reads")
            args = [jnp.asarray(x) for x in (nc, st, lo, hi)]
            name, fn = "affine-nibble", K.assign_compact_affine_nibble
            n_el = nc.size * 2
        elif kind == "delta":
            nc, dl, ok, st, _, _ = K.pack_delta_nibble(bd, 10)
            check(bool(ok.all()), "delta packer rejected deletion reads")
            args = [jnp.asarray(x) for x in (nc, st, dl)]
            name, fn = "delta-nibble", K.assign_compact_delta_nibble
            n_el = dl.size
        else:
            codes, quals, refpos = K.pack_reads(bd)
            args = [jnp.asarray(x) for x in (codes, quals, refpos)]
            name = "refpos-plane"
            fn = lambda *a, capacity: K.assign_compact_plane(  # noqa: E731
                *a, baseq=10, capacity=capacity)
            n_el = codes.size
        cap = _next_pow2(max(n_el // 32, 8192))
        step = lambda: fn(*args, jv, ji, jn, capacity=cap)  # noqa: E731
        per_launch, fetch_s, packed = _timed(step)
        r, v, a, _, nh = K.decode_packed_hits(packed)
        check(nh <= cap, "%s: %d hits overflow capacity %d" % (name, nh, cap))
        hits = assign_alleles(bd, vt, baseq=10)
        want = np.stack([hits.read_idx, hits.var_idx,
                         classify_alleles(hits, vt).astype(np.int64)])
        got = np.stack([r, v, a.astype(np.int64)])
        got = got[:, np.lexsort((got[1], got[0]))]
        want = want[:, np.lexsort((want[1], want[0]))]
        check(got.shape == want.shape and bool((got == want).all()),
              "%s: device hits differ from the host mapper (%d vs %d)"
              % (name, got.shape[1], want.shape[1]))
        times[name] = per_launch
        print("kernels: %s classify %d rows x %d cols vs %d-site table: "
              "%d hits == host mapper; %.6f s/launch (%.1f reads/s), "
              "fetch %.6f s [%s]"
              % (name, rows, args[0].shape[1], M, nh, per_launch,
                 rows / per_launch, fetch_s, card))
    return times


def check_paircount_and_components(rng) -> None:
    from types import SimpleNamespace

    from phaser_tpu.engine import blocks
    from phaser_tpu.engine.connections import build_connections

    class _VT:
        def __init__(self, n):
            self._n = n
            self.phases = ["-"] * n
            self.ind_alleles = [("A", "G")] * n

        def __len__(self):
            return self._n

    n_vars, n_reads = 50_000, 1_000_000
    v1 = rng.integers(0, n_vars, n_reads)
    v2 = np.minimum(v1 + 1 + rng.integers(0, 200, n_reads), n_vars - 1)
    keep = v1 != v2
    v1, v2 = v1[keep], v2[keep]
    uid = np.repeat(np.arange(len(v1), dtype=np.int64), 2)
    var = np.stack([v1, v2], 1).ravel().astype(np.int64)
    allele = rng.integers(0, 3, size=len(var)).astype(np.int64)
    vr = SimpleNamespace(vt=_VT(n_vars), rv_uid=uid, rv_var=var,
                         h_uid=uid, h_var=var, h_allele=allele)
    host = build_connections(vr, 0.002, 0.01, device="host")
    dev = build_connections(vr, 0.002, 0.01, device="auto")
    check(host.n_pairs >= 200_000, "pair workload below the device gate")
    for f in ("var_a", "var_b", "c_supporting", "c_total", "p_value",
              "chosen_config", "pruned"):
        check(np.array_equal(getattr(host, f), getattr(dev, f)),
              "pair counting: %s differs from the host path" % f)
    check(host.adj == dev.adj and host.allele_conn == dev.allele_conn,
          "pair counting: connection graph differs from the host path")
    print("kernels: pair counting %d reads, %d pairs == host path"
          % (len(v1), host.n_pairs))

    n = 200_000
    adj = {}
    for a, b in rng.integers(0, n, (300_000, 2)).tolist():
        if a != b:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set()).add(a)
    conn = SimpleNamespace(adj=adj, var_rank=rng.permutation(n))
    vt = SimpleNamespace(pos=rng.integers(0, 10 ** 8, n))
    hb = blocks.find_blocks(conn, vt, device="host")
    db = blocks.find_blocks(conn, vt, device="auto")
    check(hb == db, "connected components differ from the host union-find")
    print("kernels: connected components %d vertices, %d edges, %d blocks "
          "== host union-find" % (len(adj), sum(map(len, adj.values())) // 2,
                                  len(hb)))


def check_phasescore(rng, sizes=(16, 17, 18, 19, 20)) -> None:
    from phaser_tpu.engine.phasing import _vmv_scores
    from phaser_tpu.kernels.phasescore import enumerate_scores
    for n in sizes:
        M = (rng.random((2 * n, 2 * n)) < 0.5).astype(np.float32)
        S = 1 << (n - 1)
        bits = np.arange(S, dtype=np.int64)
        alleles = np.zeros((S, n), np.int64)
        alleles[:, 1:] = (bits[:, None] >> np.arange(n - 2, -1, -1)) & 1
        V = np.zeros((S, 2 * n), np.int32)
        V[np.repeat(np.arange(S), n),
          (2 * np.arange(n)[None, :] + alleles).reshape(-1)] = 1
        want = _vmv_scores(V, M.astype(np.int32))
        got = np.asarray(enumerate_scores(M, n)).astype(np.int64)
        check(np.array_equal(got, want),
              "phasescore n=%d differs from the host matmul" % n)
        print("kernels: phasescore n=%d, %d configs == host matmul "
              "(float32, precision HIGHEST), max score %d"
              % (n, S, int(want.max())))


def check_prune(rng) -> None:
    import jax.numpy as jnp
    from scipy.stats import binom

    from phaser_tpu.kernels.stats import prune_mask
    n = 1_000_000
    cfg_a = rng.integers(0, 60, n).astype(np.float64)
    cfg_b = rng.integers(0, 12, n).astype(np.float64)
    other = rng.integers(0, 8, n).astype(np.float64)
    noise_e = 0.0037
    sup = np.maximum(cfg_a, cfg_b)
    tot = cfg_a + cfg_b + other
    p_exact = binom.cdf(sup, tot, 1 - (6 * noise_e + 10 * noise_e ** 2))
    p_exact = np.where(tot - sup > 0, p_exact, 1.0)
    p_exact = np.where(sup == 0, 0.0, p_exact)
    for thr in (0.01, 0.2):
        _, prune, uncertain = map(np.asarray, prune_mask(
            jnp.asarray(cfg_a, jnp.float32), jnp.asarray(cfg_b, jnp.float32),
            jnp.asarray(other, jnp.float32), jnp.float32(noise_e), thr))
        sure = ~uncertain
        check(np.array_equal(prune[sure], (p_exact < thr)[sure]),
              "prune decisions differ from SciPy at threshold %g" % thr)
        check(bool(uncertain[np.abs(p_exact - thr) < 1e-7].all()),
              "a pair at the threshold was not flagged uncertain")
        print("kernels: prune decisions %d pairs, threshold %g == SciPy "
              "outside the 1e-3 refinement band (%d flagged)"
              % (n, thr, int(uncertain.sum())))


def check_bootstrap(rng, bs: int = 10_000, n_cohorts: int = 2048,
                    n_checked: int = 40) -> None:
    import jax
    import jax.numpy as jnp

    from phaser_tpu.kernels.bootstrap import (_bootstrap_medians,
                                              bootstrap_cis_device)
    sizes = rng.integers(40, 400, n_cohorts)
    cohorts = [rng.normal(size=int(s)) for s in sizes]
    t0 = time.perf_counter()
    dev = bootstrap_cis_device(cohorts, bs, seed=11)
    dt = time.perf_counter() - t0
    worst = 0.0
    for k in range(n_checked):
        c = cohorts[k]
        idx = np.random.default_rng(3 + k).integers(0, len(c),
                                                    (bs, len(c)))
        meds = np.median(c[idx], axis=1)
        lo, hi, p = dev[k]
        for got, want in ((lo, np.percentile(meds, 2.5)),
                          (hi, np.percentile(meds, 97.5))):
            worst = max(worst, abs(got - want))
        check(lo <= hi and 0.0 <= p <= 1.0, "bootstrap CI out of order")
    # same distribution, different RNGs: agreement within Monte-Carlo noise
    # (tests/test_bootstrap.py's tolerance; the bootstrap-median sd is ~0.2)
    check(worst < 0.1, "bootstrap CI differs from NumPy by %.4f" % worst)
    X = jnp.zeros((2048, _next_pow2(int(sizes.max()))), jnp.float32)
    mem = _bootstrap_medians.lower(
        X, jnp.ones(2048, jnp.int32), jax.random.key(0),
        bs=bs).compile().memory_analysis()
    print("kernels: bootstrap %d cohorts x bs=%d in %.3f s; %d checked vs "
          "NumPy resampling, max |dCI| %.4f < 0.1; sampler at 2048 rows: "
          "temp %d B, args %d B, out %d B"
          % (n_cohorts, bs, dt, n_checked, worst,
             mem.temp_size_in_bytes, mem.argument_size_in_bytes,
             mem.output_size_in_bytes))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    try:
        import phaser_tpu  # noqa: F401
        import datagen  # noqa: F401
    except ImportError as e:
        print("FAIL: this is not a phaser_tpu checkout (%s)" % e,
              file=sys.stderr)
        return 2
    try:
        dev, card = check_device()
        rng = np.random.default_rng(args.seed)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
            vcf, bam, sample, n_in = make_fixture(td, args.seed, N_READS)
            wall = run_engine(vcf, bam, sample, n_in, td, card)
        times = check_classifiers(rng, card)
        # the engine launches its classifiers over ~n_in reads in total
        share = times["affine-nibble"] * n_in / KERNEL_ROWS / wall
        print("kernels: classify time for the fixture's %d reads at the "
              "affine-nibble rate = %.4f of the steady engine wall [%s]"
              % (n_in, share, card))
        check_paircount_and_components(rng)
        check_phasescore(rng)
        check_prune(rng)
        check_bootstrap(rng)
    except SmokeFailure as e:
        print("FAIL: %s" % e, file=sys.stderr)
        return 1
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
