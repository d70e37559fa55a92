"""Device kernels vs host-path equivalence (CPU backend, 8 virtual devices)."""

import os
import numpy as np
import pytest

import datagen
from phaser_tpu.engine.varmap import build_variant_table
from phaser_tpu.io import vcf as vcfio
from phaser_tpu.io import bam as bamio
from phaser_tpu.mapper.host import assign_alleles, expand_refpos


def _fixture(tmp_path, seed=0, **kw):
    kw.setdefault("contigs", ("chr20",))
    kw.setdefault("n_variants_per_contig", 80)
    kw.setdefault("n_reads_per_contig", 500)
    kw.setdefault("frac_indel_reads", 0.0)   # device path covers I-free reads
    vcf, bam, data = datagen.write_fixture_dir(str(tmp_path), seed=seed, **kw)
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9) if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = build_variant_table("chr20", hs.pool["chr20"])
    bd = bamio.read_bam(bam)
    keep = (bd.refid == 0) & ((bd.flag & 0x404) == 0)
    return bd.select(keep), vt


def _device_hits(chunk, vt, baseq=10):
    import jax.numpy as jnp
    from phaser_tpu.kernels.alleles import (assign_alleles_device,
                                            compact_hits, pack_reads)
    codes, quals, refpos = pack_reads(chunk)
    vpos = jnp.asarray(vt.pos.astype(np.int32))
    ind = jnp.asarray(vt.ind_codes)
    ni = jnp.asarray(vt.n_ind)
    vidx, allele = assign_alleles_device(
        jnp.asarray(codes), jnp.asarray(quals), jnp.asarray(refpos),
        vpos, ind, ni, baseq)
    cap = int(codes.size)
    r, v, a, n = compact_hits(jnp.asarray(vidx), jnp.asarray(allele), cap)
    n = int(n)
    return np.asarray(r[:n]), np.asarray(v[:n]), np.asarray(a[:n])


def _host_hits(chunk, vt, baseq=10):
    from phaser_tpu.engine.hits import classify_alleles
    hits = assign_alleles(chunk, vt, baseq=baseq)
    allele = classify_alleles(hits, vt)
    return hits.read_idx, hits.var_idx, allele


def test_device_allele_assignment_matches_host(tmp_path):
    chunk, vt = _fixture(tmp_path)
    assert np.all(np.diff(vt.pos) > 0)  # device path needs unique positions
    hr, hv, ha = _host_hits(chunk, vt)
    dr, dv, da = _device_hits(chunk, vt)
    assert len(hr) > 50
    np.testing.assert_array_equal(dr, hr)
    np.testing.assert_array_equal(dv, hv)
    np.testing.assert_array_equal(da, ha)


def test_binom_cdf_matches_scipy():
    from scipy.stats import binom
    from phaser_tpu.kernels.stats import binom_cdf
    rng = np.random.default_rng(0)
    n = rng.integers(1, 200, 200)
    k = (n * rng.random(200)).astype(int)
    p = rng.uniform(0.001, 0.999, 200)
    ours = np.asarray(binom_cdf(k, n, p))
    ref = binom.cdf(k, n, p)
    # float32 betainc: ~1e-4; the engine's pruning decisions use the exact
    # float64 host path, this kernel powers the all-device pipeline
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_phasescore_matches_host():
    from phaser_tpu.engine.phasing import _score_configs, inverse_config
    from phaser_tpu.kernels.phasescore import enumerate_scores
    rng = np.random.default_rng(1)
    for n in (2, 3, 5, 8):
        variants = list(range(n))
        ac = {}
        for _ in range(n * 3):
            i, j = rng.integers(0, n, 2)
            if i == j:
                continue
            a, b = rng.integers(0, 2, 2)
            ac.setdefault((int(i), int(a)), set()).add((int(j), int(b)))
            ac.setdefault((int(j), int(b)), set()).add((int(i), int(a)))
        configs = []
        for bits in range(2 ** (n - 1)):
            configs.append("0" + format(bits, "0%db" % (n - 1))[:n - 1]
                           if n > 1 else "0")
        host = _score_configs(variants, ac, configs)
        local = {v: i for i, v in enumerate(variants)}
        M = np.zeros((2 * n, 2 * n), np.float32)
        for (v, a), conns in ac.items():
            for (w, b) in conns:
                M[local[v] * 2 + a, local[w] * 2 + b] = 1
        dev = np.asarray(enumerate_scores(M, n)).astype(int)
        np.testing.assert_array_equal(dev, host)


def test_paircount_matches_engine(tmp_path):
    import jax.numpy as jnp
    from phaser_tpu.engine.hits import build_contig_rows, build_variant_reads
    from phaser_tpu.engine.connections import build_connections
    from phaser_tpu.kernels.paircount import (count_pair_configs, emit_pairs,
                                              pack_read_hits)
    chunk, vt = _fixture(tmp_path, seed=2, contig_len=20000,
                         n_reads_per_contig=1200)
    hits = assign_alleles(chunk, vt, baseq=10)
    rows = build_contig_rows(vt, [(0, chunk, hits)], {0: None}, {0: 0})
    vr = build_variant_reads(rows, [])
    conn = build_connections(vr, 0.002, 0.01)

    K = 24
    var_mat, allele_mat, overflow = pack_read_hits(vr.h_uid, vr.h_var,
                                                   vr.h_allele, K)
    assert len(overflow) == 0
    lo, hi, al, ah = emit_pairs(jnp.asarray(var_mat), jnp.asarray(allele_mat), K)
    keys, counts, n_uniq = count_pair_configs(lo, hi, al, ah, len(vt),
                                              max_pairs=4096)
    n_uniq = int(n_uniq)
    keys = np.asarray(keys[:n_uniq])
    counts = np.asarray(counts[:n_uniq]).reshape(n_uniq, 3, 3)
    # engine counts for comparison
    dev = {}
    for k in range(n_uniq):
        dev[int(keys[k])] = counts[k]
    # rebuild engine-side counts from conn: config_a etc. can't be inverted,
    # so recompute via the same enumeration on host
    from phaser_tpu.engine.connections import _pair_combos
    horder = np.argsort(vr.h_uid, kind="stable")
    ci, cj, cai, caj = _pair_combos(vr.h_uid[horder], vr.h_var[horder],
                                    vr.h_allele[horder])
    host = {}
    for a, b, x, y in zip(ci, cj, cai, caj):
        key = int(a) * len(vt) + int(b)
        host.setdefault(key, np.zeros((3, 3), np.int64))[int(x), int(y)] += 1
    assert set(dev.keys()) == set(host.keys())
    for k in host:
        np.testing.assert_array_equal(dev[k], host[k])
    # and the engine's pair stats derive from these counts
    assert conn.n_pairs <= len(host)


def test_sharded_allele_counts():
    import jax
    from phaser_tpu.dist.mesh import (make_mesh, pad_to_multiple,
                                      sharded_allele_counts)
    assert len(jax.devices()) == 8
    rng = np.random.default_rng(0)
    N, L, M = 64, 128, 50
    codes = rng.integers(0, 16, (N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, (N, L)).astype(np.uint8)
    refpos = np.sort(rng.integers(1, 5000, (N, L)).astype(np.int32), axis=1)
    vpos = np.sort(rng.choice(np.arange(1, 5000), M, replace=False)).astype(np.int32)
    ind = rng.integers(1, 15, (M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)

    mesh = make_mesh(8)
    counts = np.asarray(sharded_allele_counts(
        mesh, codes, quals, refpos, vpos, ind, ni, 10))

    # single-device reference
    from phaser_tpu.kernels.alleles import assign_alleles_device
    import jax.numpy as jnp
    vidx, allele = assign_alleles_device(jnp.asarray(codes), jnp.asarray(quals),
                                         jnp.asarray(refpos), jnp.asarray(vpos),
                                         jnp.asarray(ind), jnp.asarray(ni), 10)
    vidx, allele = np.asarray(vidx), np.asarray(allele)
    ref = np.zeros((M, 3), np.int64)
    hit = allele < 3
    np.add.at(ref, (vidx[hit], allele[hit]), 1)
    np.testing.assert_array_equal(counts, ref)


def test_multihost_scaffolding_single_process():
    """Single-process path of the multi-host scaffolding: global arrays from
    process-local tensors + the sharded step over the virtual mesh."""
    import jax
    from phaser_tpu.dist import multihost
    from phaser_tpu.dist.mesh import make_mesh

    multihost.initialize()  # no-op single process
    shards = multihost.position_shards(10000, 4, halo=200)
    assert shards[0] == (0, 2700)
    assert shards[-1][1] == 10000

    rng = np.random.default_rng(3)
    N, L, M = 64, 128, 32
    codes = rng.integers(0, 16, (N, L)).astype(np.uint8)
    quals = rng.integers(0, 40, (N, L)).astype(np.uint8)
    refpos = np.sort(rng.integers(1, 3000, (N, L)).astype(np.int32), axis=1)
    vpos = np.sort(rng.choice(np.arange(1, 3000), M, replace=False)).astype(np.int32)
    ind = rng.integers(1, 15, (M, 2)).astype(np.uint8)
    ni = np.full(M, 2, np.int8)
    mesh = make_mesh(8)
    counts, pair, prune, scores = multihost.run_sharded_step(
        mesh, codes, quals, refpos, vpos, ind, ni, 10)
    assert counts.shape == (M, 3)
    assert prune.shape == (M, 8)
    assert int(np.asarray(counts).sum()) > 0


def test_device_prune_decisions_match_scipy():
    """kernels.stats.prune_mask: decisions equal scipy's outside the
    refinement band, and exact-boundary cases are flagged uncertain
    (reference math phaser.py:1649, pruning :696-707)."""
    import jax.numpy as jnp
    from scipy.stats import binom
    from phaser_tpu.kernels.stats import prune_mask

    rng = np.random.default_rng(7)
    n = 4000
    cfg_a = rng.integers(0, 40, n).astype(np.float64)
    cfg_b = rng.integers(0, 8, n).astype(np.float64)
    other = rng.integers(0, 6, n).astype(np.float64)
    noise_e = 0.0037
    sup = np.maximum(cfg_a, cfg_b)
    tot = cfg_a + cfg_b + other
    p_exact = binom.cdf(sup, tot, 1 - (6 * noise_e + 10 * noise_e ** 2))
    p_exact = np.where(tot - sup > 0, p_exact, 1.0)
    p_exact = np.where(sup == 0, 0.0, p_exact)

    for thr in (0.01, 0.2,
                # thresholds straddling an achievable p-value by 1e-9:
                float(np.median(p_exact[(p_exact > 0) & (p_exact < 1)]))
                + 1e-9):
        p, prune, uncertain = prune_mask(
            jnp.asarray(cfg_a, jnp.float32), jnp.asarray(cfg_b, jnp.float32),
            jnp.asarray(other, jnp.float32), jnp.float32(noise_e), thr)
        p, prune, uncertain = map(np.asarray, (p, prune, uncertain))
        sure = ~uncertain
        np.testing.assert_array_equal(prune[sure], (p_exact < thr)[sure])
        # any pair whose exact p is within 1e-7 of the threshold must be
        # flagged for host refinement, never silently mis-decided
        near = np.abs(p_exact - thr) < 1e-7
        assert uncertain[near].all()


def test_find_weak_points_matches_naive():
    """Difference-array weak-point counts == the reference's per-position
    increment semantics (phaser.py:2309-2324) on dense random graphs."""
    from phaser_tpu.engine.phasing import find_weak_points

    rng = np.random.default_rng(11)
    for n in (4, 5, 9, 40, 120):
        variants = list(rng.choice(np.arange(10 * n), n, replace=False))
        conns = {}
        for _ in range(3 * n):
            a, b = rng.integers(0, n, 2)
            if a == b:
                continue
            conns.setdefault(variants[a], set()).add(variants[b])
        index = {v: i for i, v in enumerate(variants)}
        naive = {p: 0 for p in range(2, n - 1)}
        for xvar, cs in conns.items():
            for c in cs:
                i, j = index[xvar], index[c]
                if i < j:
                    for p in range(max(i + 1, 2), min(j, n - 2) + 1):
                        naive[p] += 1
        assert find_weak_points(variants, conns) == naive


def test_scaling_bench_smoke(capsys):
    """Scaling harness end-to-end at 1,2 virtual devices (tiny sizes)."""
    import json
    from phaser_tpu.dist import scaling_bench

    rc = scaling_bench.main(["--devices", "1,2", "--reads-per-device", "256",
                             "--read-len", "32", "--variants", "64",
                             "--iters", "2"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    assert res["metric"] == "weak_scaling_efficiency"
    assert res["per_device"]["2"]["reads"] == 512
    assert res["per_device"]["2"]["hits"] > 0


def test_multiprocess_psum_counts_match_single(tmp_path):
    """TRUE 2-process run (jax.distributed + Gloo psum): per-host shard
    ingest -> global arrays -> cross-process count merge, bit-identical to
    the single-process result."""
    import json
    import socket
    import subprocess
    import sys

    import datagen
    from phaser_tpu.dist.multihost import multiprocess_allele_counts

    vcf, bam, data = datagen.write_fixture_dir(
        str(tmp_path), seed=5, n_variants_per_contig=60,
        n_reads_per_contig=400, contig_len=60000)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out0 = str(tmp_path / "mh0.json")
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "phaser_tpu.dist.multihost",
               "--bam", bam, "--vcf", vcf, "--sample", "SAMPLE1",
               "--num-processes", "2", "--process-id", str(pid),
               "--coordinator", "localhost:%d" % port]
        if pid == 0:
            cmd += ["--o", out0]
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS",)}
        procs.append(subprocess.Popen(cmd, cwd=repo, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-2000:]

    c2 = np.array(json.load(open(out0))["counts"])
    c1 = multiprocess_allele_counts(bam, vcf, "SAMPLE1", 1, 0)
    assert c2.sum() > 0
    np.testing.assert_array_equal(c1, c2)


def test_pack_affine_matches_numpy_classifier(tmp_path):
    """C++ fused pack+affine == pack_codes_quals + _affine_params on reads
    with clips, splices, deletions, insertions."""
    from phaser_tpu.kernels.alleles import pack_affine, pack_codes_quals
    from phaser_tpu.mapper.dispatch import _affine_params

    data = datagen.generate(seed=21, contigs=("chr1",), contig_len=100000,
                            n_variants_per_contig=50, n_reads_per_contig=400,
                            read_len=90, frac_spliced=0.3,
                            frac_indel_reads=0.2, frac_softclip=0.3)
    p = str(tmp_path / "x.bam")
    data.write_bam(p)
    bd = bamio.read_bam(p)
    out = pack_affine(bd)
    assert out is not None
    codes, quals, is_aff, start, lo, hi = out
    c2, q2 = pack_codes_quals(bd)
    np.testing.assert_array_equal(codes, c2)
    np.testing.assert_array_equal(quals, q2)
    ia, st, l2, h2 = _affine_params(bd)
    np.testing.assert_array_equal(is_aff, ia)
    np.testing.assert_array_equal(start, st)
    np.testing.assert_array_equal(lo[ia], l2[ia])
    np.testing.assert_array_equal(hi[ia], h2[ia])
    assert is_aff.sum() > 0 and (~is_aff).sum() > 0


def test_dispatch_sub_batching_matches_host(tmp_path, monkeypatch):
    """Device dispatch with tiny sub-batch size (forcing many launches,
    offsets, and adaptive caps) == exact host path."""
    from phaser_tpu.mapper import dispatch
    from phaser_tpu.mapper.host import assign_alleles
    from phaser_tpu.engine.varmap import build_variant_table

    monkeypatch.setattr(dispatch, "_SUB_ROWS", 64)
    data = datagen.generate(seed=31, contigs=("chr1",), contig_len=200000,
                            n_variants_per_contig=300,
                            n_reads_per_contig=500, read_len=80,
                            frac_spliced=0.25, frac_indel_reads=0.1,
                            frac_softclip=0.2)
    p = str(tmp_path / "x.bam")
    data.write_bam(p)
    bd = bamio.read_bam(p)
    recs = []
    for v in data.variants:
        recs.append([v.chrom, str(v.pos), v.rsid, v.ref, ",".join(v.alts),
                     "100", v.filt, "AF=%g" % v.af, "GT", v.gt,
                     [c for c in v.gt if c not in "|/"]])
    vt = build_variant_table("chr1", recs)
    want = assign_alleles(bd, vt, baseq=10, splice=True)
    # twice: second run uses adaptive (shrunken) caps from feedback
    for _ in range(2):
        got = dispatch.assign_alleles_auto(bd, vt, baseq=10, splice=True,
                                           device="auto")
        np.testing.assert_array_equal(got.read_idx, want.read_idx)
        np.testing.assert_array_equal(got.var_idx, want.var_idx)
        np.testing.assert_array_equal(got.allele_code, want.allele_code)
        assert got.allele_strs == want.allele_strs


def test_pack_affine_masked_matches_two_plane(tmp_path):
    """Masked single-plane pack == where(q>=baseq, codes, 15) of the
    two-plane pack; classification fields identical."""
    from phaser_tpu.kernels.alleles import (pack_affine, pack_affine_masked,
                                            pack_codes_quals)

    data = datagen.generate(seed=22, contigs=("chr1",), contig_len=80000,
                            n_variants_per_contig=40, n_reads_per_contig=300,
                            read_len=70, frac_spliced=0.3,
                            frac_indel_reads=0.15, frac_softclip=0.25)
    p = str(tmp_path / "x.bam")
    data.write_bam(p)
    bd = bamio.read_bam(p)
    mcodes, ia, st, lo, hi = pack_affine_masked(bd, 13)
    codes, quals = pack_codes_quals(bd)
    want = np.where(quals >= 13, codes, np.uint8(15))
    # pad columns beyond each read's length: masked plane uses 15, the
    # two-plane form has codes=0/quals=0 -> masked 15 as well (13 > 0)
    np.testing.assert_array_equal(mcodes, want)
    _, _, ia2, st2, lo2, hi2 = pack_affine(bd)
    np.testing.assert_array_equal(ia, ia2)
    np.testing.assert_array_equal(st, st2)
    np.testing.assert_array_equal(lo, lo2)
    np.testing.assert_array_equal(hi, hi2)


def test_pack_affine_nibble_matches_masked(tmp_path):
    """Nibble plane (2 bases/byte) unpacks to exactly the masked plane,
    including odd read lengths (high-nibble pad on the tail byte) and
    low-qual masking; affine classification fields identical."""
    from phaser_tpu.kernels.alleles import (pack_affine_masked,
                                            pack_affine_nibble)

    data = datagen.generate(seed=23, contigs=("chr1",), contig_len=80000,
                            n_variants_per_contig=40, n_reads_per_contig=300,
                            read_len=71,  # odd: exercises the tail nibble
                            frac_spliced=0.3, frac_indel_reads=0.15,
                            frac_softclip=0.25)
    p = str(tmp_path / "x.bam")
    data.write_bam(p)
    bd = bamio.read_bam(p)
    nb = pack_affine_nibble(bd, 13)
    assert nb is not None, "native library required in this environment"
    ncodes, ia, st, lo, hi = nb
    mcodes, ia2, st2, lo2, hi2 = pack_affine_masked(bd, 13)
    N, Lh = ncodes.shape
    unp = np.stack([ncodes & 0xF, ncodes >> 4], axis=-1).reshape(N, 2 * Lh)
    Lm = mcodes.shape[1]
    W = min(Lm, 2 * Lh)
    np.testing.assert_array_equal(unp[:, :W], mcodes[:, :W])
    assert np.all(unp[:, W:] == 15)
    assert np.all(mcodes[:, W:] == 15)
    np.testing.assert_array_equal(ia, ia2)
    np.testing.assert_array_equal(st, st2)
    np.testing.assert_array_equal(lo, lo2)
    np.testing.assert_array_equal(hi, hi2)


def test_nibble_kernel_matches_masked_kernel(tmp_path):
    """Fused nibble device kernel produces the identical packed-hit buffer
    as the masked-plane kernel on the same reads."""
    import jax.numpy as jnp
    from phaser_tpu.kernels.alleles import (assign_compact_affine_masked,
                                            assign_compact_affine_nibble,
                                            decode_packed_hits,
                                            pack_affine_masked,
                                            pack_affine_nibble)

    chunk, vt = _fixture(tmp_path, seed=11, n_reads_per_contig=400)
    nb = pack_affine_nibble(chunk, 10)
    mk = pack_affine_masked(chunk, 10)
    assert nb is not None and mk is not None
    ncodes, ia, st, lo, hi = nb
    mcodes = mk[0]
    stk = np.where(ia, st, 0).astype(np.int32)
    lok = np.where(ia, lo, 0).astype(np.int32)
    hik = np.where(ia, hi, 0).astype(np.int32)
    vpos = jnp.asarray(vt.pos.astype(np.int32))
    ind = jnp.asarray(vt.ind_codes)
    ni = jnp.asarray(vt.n_ind)
    cap = 1 << 14
    pn = assign_compact_affine_nibble(
        jnp.asarray(ncodes), jnp.asarray(stk), jnp.asarray(lok),
        jnp.asarray(hik), vpos, ind, ni, cap)
    pm = assign_compact_affine_masked(
        jnp.asarray(mcodes), jnp.asarray(stk), jnp.asarray(lok),
        jnp.asarray(hik), vpos, ind, ni, cap)
    rn, vn, an, mn, nn = decode_packed_hits(np.asarray(pn))
    rm, vm, am, mm, nm = decode_packed_hits(np.asarray(pm))
    assert nn == nm and nn > 20
    np.testing.assert_array_equal(rn, rm)
    np.testing.assert_array_equal(vn, vm)
    np.testing.assert_array_equal(an, am)
    np.testing.assert_array_equal(mn, mm)


def test_delta_nibble_matches_plane(tmp_path):
    """int16-delta refpos device format (2.5 B/base vs the 6 B/base plane
    form) must classify D/split-M reads identically to the refpos-plane
    kernel."""
    import jax.numpy as jnp
    from phaser_tpu.kernels.alleles import (assign_compact_delta_nibble,
                                            assign_compact_plane,
                                            decode_packed_hits,
                                            pack_delta_nibble, pack_reads)

    chunk, vt = _fixture(tmp_path, seed=44, contig_len=30000,
                         n_variants_per_contig=150, n_reads_per_contig=400,
                         frac_spliced=0.35, frac_indel_reads=0.5)
    dn = pack_delta_nibble(chunk, 10)
    assert dn is not None
    ncd, dlt, okm, dst, _, _ = dn
    ok_idx = np.flatnonzero(okm)
    assert ok_idx.size > 10, "fixture must contain D/split-M reads"
    # delta-ok rows exclude spliced/insertion/affine reads
    opc = chunk.cigar_flat & 0xF
    ops_per = np.diff(chunk.cigar_off)
    op_read = np.repeat(np.arange(len(chunk)), ops_per)
    for bad_op in (1, 3):  # I, N
        has = np.zeros(len(chunk), bool)
        np.logical_or.at(has, op_read, opc == bad_op)
        assert not has[ok_idx].any()

    sub = chunk.select(ok_idx)
    codes, quals, refpos = pack_reads(sub)
    vpos = vt.pos.astype(np.int32)
    cap = 1 << 13
    pn = assign_compact_plane(
        jnp.asarray(codes), jnp.asarray(quals), jnp.asarray(refpos),
        jnp.asarray(vpos), jnp.asarray(vt.ind_codes),
        jnp.asarray(vt.n_ind), 10, cap)
    pd = assign_compact_delta_nibble(
        jnp.asarray(ncd[ok_idx]), jnp.asarray(dst[ok_idx]),
        jnp.asarray(dlt[ok_idx]), jnp.asarray(vpos),
        jnp.asarray(vt.ind_codes), jnp.asarray(vt.n_ind), cap)
    rn = decode_packed_hits(np.asarray(pn))
    rd = decode_packed_hits(np.asarray(pd))
    assert rd[4] == rn[4] and rd[4] > 5, (rd[4], rn[4])
    for a, b in zip(rd[:4], rn[:4]):
        np.testing.assert_array_equal(a, b)
