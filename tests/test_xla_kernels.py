"""The XLA allele classifiers against the host mapper, and the pieces that
choose and configure the device path: the CLI's --device choices, the
compile-cache location, the pinned phase-score precision, and chip_smoke.py's
refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import datagen
from phaser_tpu.engine.hits import classify_alleles
from phaser_tpu.engine.varmap import build_variant_table
from phaser_tpu.io import bam as bamio
from phaser_tpu.io import vcf as vcfio
from phaser_tpu.kernels import alleles as K
from phaser_tpu.mapper.dispatch import _read_op_masks
from phaser_tpu.mapper.host import assign_alleles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reads_and_table(tmp_path_factory):
    """One contig of reads with soft clips, splices, deletions and
    insertions (odd read length: a half-filled tail byte in the nibble
    formats) and its het-site table."""
    td = str(tmp_path_factory.mktemp("xla"))
    vcf, bam, _ = datagen.write_fixture_dir(
        td, seed=61, contigs=("chr20",), contig_len=60000,
        n_variants_per_contig=400, n_reads_per_contig=2500, read_len=75,
        frac_spliced=0.3, frac_indel_reads=0.5, frac_softclip=0.2)
    lines = [l for l in vcfio.het_filtered_lines(vcf, 9)
             if not l.startswith("#")]
    hs = vcfio.parse_het_sites(lines, "", ["_", ":"], True)
    vt = build_variant_table("chr20", hs.pool["chr20"])
    assert np.all(np.diff(vt.pos) > 0) and vt.is_simple.all()
    bd = bamio.read_bam(bam)
    return bd.select((bd.refid == 0) & ((bd.flag & 0x404) == 0)), vt


def _eligible(chunk, fmt):
    """Reads each device format carries (mapper.dispatch's routing)."""
    if fmt == "affine_nibble":
        return K.pack_affine_nibble(chunk, 10)[1]
    if fmt == "delta_nibble":
        return K.pack_delta_nibble(chunk, 10)[2]
    has_ins, _ = _read_op_masks(chunk)
    return ~has_ins


def _run_format(sub, vt, fmt, trim):
    """Packed hits of `sub` through one XLA kernel; `trim` cuts the planes
    to the longest read, a width that is not a multiple of 128."""
    import jax.numpy as jnp
    vpos = jnp.asarray(vt.pos.astype(np.int32))
    ind, ni = jnp.asarray(vt.ind_codes), jnp.asarray(vt.n_ind)
    width = int(np.diff(sub.seq_off).max())
    half = (width + 1) // 2
    cap = 1 << 14
    if fmt == "affine_nibble":
        nc, aff, st, lo, hi = K.pack_affine_nibble(sub, 10)
        assert aff.all()
        if trim:
            assert np.all(nc[:, half:] == 0xFF)
            nc = nc[:, :half]
        out = K.assign_compact_affine_nibble(
            jnp.asarray(nc), jnp.asarray(st), jnp.asarray(lo),
            jnp.asarray(hi), vpos, ind, ni, cap)
    elif fmt == "delta_nibble":
        nc, dl, ok, st, _, _ = K.pack_delta_nibble(sub, 10)
        assert ok.all()
        if trim:
            assert np.all(nc[:, half:] == 0xFF)
            nc, dl = nc[:, :half], dl[:, :2 * half]
        out = K.assign_compact_delta_nibble(
            jnp.asarray(nc), jnp.asarray(st), jnp.asarray(dl), vpos, ind,
            ni, cap)
    else:
        codes, quals, refpos = K.pack_reads(sub)
        if trim:
            assert np.all(refpos[:, width:] == 0)
            codes, quals, refpos = (x[:, :width]
                                    for x in (codes, quals, refpos))
        out = K.assign_compact_plane(
            jnp.asarray(codes), jnp.asarray(quals), jnp.asarray(refpos),
            vpos, ind, ni, 10, cap)
    if trim:
        assert width % 128 != 0
    return K.decode_packed_hits(np.asarray(out))


@pytest.mark.parametrize("trim", [False, True], ids=["pad128", "trimmed"])
@pytest.mark.parametrize("n_rows", [1, 37, 150])
@pytest.mark.parametrize("fmt", ["affine_nibble", "delta_nibble", "plane"])
def test_xla_format_matches_host(reads_and_table, fmt, n_rows, trim):
    chunk, vt = reads_and_table
    host_all = assign_alleles(chunk, vt, baseq=10)
    with_hit = np.zeros(len(chunk), bool)
    with_hit[host_all.read_idx] = True
    cand = np.flatnonzero(_eligible(chunk, fmt) & with_hit)
    assert cand.size >= n_rows, (fmt, cand.size)
    rows = np.sort(np.random.default_rng(n_rows).choice(
        cand, n_rows, replace=False))
    sub = chunk.select(rows)
    r, v, a, _, nh = _run_format(sub, vt, fmt, trim)
    hits = assign_alleles(sub, vt, baseq=10)
    want = sorted(zip(hits.read_idx.tolist(), hits.var_idx.tolist(),
                      classify_alleles(hits, vt).tolist()))
    assert nh == len(want) > 0
    assert sorted(zip(r.tolist(), v.tolist(), a.tolist())) == want


def _cli_argv(tmp_path, device):
    vcf, bam, data = datagen.write_fixture_dir(
        str(tmp_path), seed=62, contigs=("chr20",), contig_len=20000,
        n_variants_per_contig=80, n_reads_per_contig=600)
    out = str(tmp_path / ("out_" + device))
    return ["--vcf", vcf, "--bam", bam, "--sample", data.sample,
            "--mapq", "10", "--baseq", "10", "--paired_end", "1",
            "--o", out, "--device", device], out


def test_device_gpu_without_gpu_fails_with_record(tmp_path):
    from phaser_tpu.cli.phaser_main import main
    argv, out = _cli_argv(tmp_path, "gpu")
    assert main(argv) == 1
    with open(out + ".failure.json") as f:
        record = json.load(f)
    assert "no GPU" in json.dumps(record)
    assert not os.path.exists(out + ".haplotypes.txt")


def test_device_auto_on_cpu_runs_xla_kernels(tmp_path, monkeypatch):
    from phaser_tpu.cli.phaser_main import main
    from phaser_tpu.utils import trace
    calls = []
    for name in ("assign_compact_affine_nibble",
                 "assign_compact_delta_nibble", "assign_compact_plane"):
        kern = getattr(K, name)

        def counted(*a, _kern=kern, _name=name, **kw):
            calls.append(_name)
            return _kern(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    fb0 = trace.device_fallbacks()
    argv, out = _cli_argv(tmp_path, "auto")
    assert main(argv) == 0
    assert "assign_compact_affine_nibble" in calls
    assert trace.device_fallbacks() == fb0
    host_argv, host_out = _cli_argv(tmp_path, "host")
    assert main(host_argv) == 0
    import chip_smoke
    assert chip_smoke.compare_outputs(out, host_out) == []


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR is left to JAX; without it the cache and
    its sidecars go to one fixed, git-ignored directory in the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = (
        "import json, jax\n"
        "from phaser_tpu.utils import jaxtune\n"
        "from phaser_tpu.mapper.dispatch import _cap_path\n"
        "from phaser_tpu.analysis.cis_var import _pop_warm_path\n"
        "jaxtune.enable_compile_cache()\n"
        "print(json.dumps([jax.config.jax_compilation_cache_dir,\n"
        "                  jaxtune.cache_dir(), _cap_path(),\n"
        "                  _pop_warm_path()]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_dir, cache, caps, warm = json.loads(proc.stdout.splitlines()[-1])
    want = str(tmp_path / "cc") if env_dir else \
        os.path.join(REPO, ".jax_cache")
    assert jax_dir == cache == want
    assert caps == os.path.join(want, "hit_caps.json")
    assert warm == os.path.join(want, "pop_warm.json")
    if not env_dir:
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("n", [16, 17, 18])
def test_phasescore_exact_at_pinned_precision(n):
    """Dense 0/1 adjacencies score exactly against the host matmul, and the
    matmul asks for HIGHEST precision rather than the backend default."""
    import jax

    import chip_smoke
    from phaser_tpu.kernels.phasescore import enumerate_scores
    chip_smoke.check_phasescore(np.random.default_rng(n), sizes=(n,))
    M = np.ones((2 * n, 2 * n), np.float32)
    jaxpr = str(jax.make_jaxpr(enumerate_scores, static_argnums=1)(M, n))
    assert "Precision.HIGHEST" in jaxpr


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not gpu" in proc.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("suffix", ["haplotypes.txt", "vcf.gz"])
def test_chip_smoke_comparator_flags_one_byte(tmp_path, suffix):
    import gzip

    import chip_smoke
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for prefix in (a, b):
        for sfx in chip_smoke.OUTPUT_SUFFIXES:
            body = ("%s\tcontent\n" % sfx).encode()
            with open(prefix + "." + sfx, "wb") as f:
                f.write(gzip.compress(body, mtime=0) if sfx.endswith(".gz")
                        else body)
    assert chip_smoke.compare_outputs(a, b) == []
    path = b + "." + suffix
    with open(path, "rb") as f:
        raw = f.read()
    if suffix.endswith(".gz"):
        body = bytearray(gzip.decompress(raw))
        body[0] ^= 1
        raw = gzip.compress(bytes(body), mtime=0)
    else:
        raw = bytes([raw[0] ^ 1]) + raw[1:]
    with open(path, "wb") as f:
        f.write(raw)
    assert chip_smoke.compare_outputs(a, b) == [suffix]
