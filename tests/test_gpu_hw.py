"""Card tests: the device kernels and the CLI's --device gpu path on a GPU.

Every test here is marked `gpu`. The suite's own process is pinned to the
CPU (conftest.py), so each test runs its check in a child process that
leaves JAX's default platform in place; the `gpu_env` fixture first asks a
child which platform JAX finds and skips the test when it is not a GPU.
On a machine with the card:

    python -m pytest tests/test_gpu_hw.py -m gpu -p no:cacheprovider

One child runs at a time, so the card is never shared between processes.
The checks are chip_smoke.py's, at smaller sizes.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gpu_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    out = proc.stdout.strip().splitlines()
    platform = out[-1] if proc.returncode == 0 and out else "none"
    if platform != "gpu":
        pytest.skip("no GPU: JAX's default platform here is %r" % platform)
    return env


def _run_on_gpu(env, body: str, timeout: int = 1200) -> str:
    code = ("import sys\n"
            "sys.path[:0] = [%r, %r]\n"
            "import numpy as np\n"
            "import chip_smoke as cs\n"
            "dev, card = cs.check_device()\n"
            "rng = np.random.default_rng(0)\n"
            % (REPO, os.path.join(REPO, "tests"))) + body
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stderr[-3000:] or proc.stdout[-3000:])
    return proc.stdout


@pytest.mark.gpu
def test_classifiers_match_host_on_gpu(gpu_env):
    out = _run_on_gpu(gpu_env, (
        "cs.check_classifiers(rng, card, rows=1 << 16, sites=20000,\n"
        "                     contig_len=10_000_000)\n"))
    assert out.count("== host mapper") == 3


@pytest.mark.gpu
def test_engine_gpu_matches_host(gpu_env, tmp_path):
    out = _run_on_gpu(gpu_env, (
        "vcf, bam, sample, n = cs.make_fixture(%r, 1, 60000)\n"
        "cs.run_engine(vcf, bam, sample, n, %r, card)\n"
        % (str(tmp_path), str(tmp_path))))
    assert "byte-identical" in out


@pytest.mark.gpu
def test_graph_scoring_and_stats_kernels_on_gpu(gpu_env):
    out = _run_on_gpu(gpu_env, (
        "cs.check_paircount_and_components(rng)\n"
        "cs.check_phasescore(rng, sizes=(16, 18))\n"
        "cs.check_prune(rng)\n"
        "cs.check_bootstrap(rng, n_cohorts=256)\n"))
    assert "bootstrap" in out
