"""cis_var jax bootstrap engine: deterministic columns identical to the
numpy engine; CI bounds statistically consistent."""

import pandas as pd

from phaser_tpu.analysis.cis_var import run_cis_var
from test_pop_parity import _make_cis_var_inputs

# every non-CI column: byte-identical across engines (the four CI
# lower/upper pairs + var_het_pval are the only engine-specific columns,
# documented in cli/cis_var_main.py --engine help)
DET = ["gene", "var_id", "var_chr", "var_pos", "var_het_n", "var_hom_n",
       "het_hom_pvalue", "var_het_afc", "var_het_abs_afc", "var_hom_afc",
       "var_hom_abs_afc", "var_het_afcs", "var_hom_afcs",
       "var_het_ref_counts", "var_het_alt_counts", "var_hom_hap1_counts",
       "var_hom_hap2_counts", "var_het_sample_ids", "var_hom_sample_ids"]


def test_cis_var_jax_engine(tmp_path):
    bed, vcf, pairs, smap = _make_cis_var_inputs(tmp_path, n_samples=80,
                                                 n_genes=10, n_vars=40)
    a = str(tmp_path / "np.txt")
    b = str(tmp_path / "jx.txt")
    run_cis_var(bed, vcf, pairs, smap, a, bs=500, engine="numpy",
                log=lambda *x: None)
    run_cis_var(bed, vcf, pairs, smap, b, bs=500, engine="jax",
                log=lambda *x: None)
    A = pd.read_csv(a, sep="\t")
    B = pd.read_csv(b, sep="\t")
    for c in DET:
        assert A[c].fillna("").tolist() == B[c].fillna("").tolist(), c
    m = A["var_het_n"] > 3
    if m.any():
        delta = (A["var_het_afc_lower"] - B["var_het_afc_lower"])[m].abs()
        # bounds from different RNGs but same distribution
        assert float(delta.max()) < 2.0
        # ordering invariant: lower <= point <= upper
        assert (B["var_het_afc_lower"][m] <= B["var_het_afc"][m] + 1e-6).all()
        assert (B["var_het_afc"][m] <= B["var_het_afc_upper"][m] + 1e-6).all()


def test_pop_warm_marker(tmp_path, monkeypatch):
    """The auto-engine gate consults a warm marker next to the persistent
    jit cache: cold caches use the ~64M pairs*bs crossover (a cold
    compile makes small workloads a loss), warm ones ~8M."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    from phaser_tpu.analysis import cis_var
    assert not cis_var._pop_is_warm("gpu", 10000)
    cis_var._pop_mark_warm("gpu", 10000)
    assert cis_var._pop_is_warm("gpu", 10000)
    assert not cis_var._pop_is_warm("gpu", 500)
    assert not cis_var._pop_is_warm("cpu", 10000)
