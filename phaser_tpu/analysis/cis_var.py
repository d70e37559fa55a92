"""phASER-POP cis-var: cis-regulatory effect sizes (aFC) from the gw_phased
expression matrix + a population VCF.

Parity implementation of /root/reference/phaser_pop/phaser_cis_var.py
(modulo its py2 leftovers): per (gene, variant) pair, per phased-het sample
compute aFC = log2((aCount+pc)/(bCount+pc)) sign-oriented ALT/REF; homozygous
samples form the null cohort; bootstrap median CIs + empirical p + Wilcoxon
rank-sum het-vs-hom |aFC| test.

The reference bootstraps with the global unseeded numpy RNG; we use a
deterministic per-pair seeded Generator (set `bs_seed`).  Point estimates,
cohort lists, and the rank-sum test are exactly reproducible; CI bounds are
statistically equivalent.

Unlike the reference's per-pair x per-sample Python loop (string-splitting
every matrix cell and VCF genotype on every visit, phaser_cis_var.py:131-159),
the expression matrix is parsed ONCE into dense (genes x samples) count
arrays, the sample <-> column correspondence is hoisted out of the pair loop,
and genotype classification runs vectorized per record; only the per-sample
aFC accumulation (a handful of float ops on the eligible cohort) stays
scalar, preserving math.log bit-for-bit output parity. The default engine
batches ALL pairs' bootstrap draws in one device dispatch
(kernels.bootstrap).
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
from scipy.stats import ranksums

from ..io import bgzf, tabix


def _parse_count_cells(cells: np.ndarray):
    """Parse one sample column of "aCount|bCount[|...]" cells.

    Returns (a, b, total, ok): first two |-fields, the sum of ALL fields
    (the reference's min_cov test sums every field,
    phaser_cis_var.py:143-144), and an eligibility mask. Cells that do not
    parse as |-separated floats with >= 2 fields get ok=False — the
    reference would crash on such a cell when the pair loop visits it; we
    mark the sample ineligible for that gene instead (documented
    divergence, fail-soft).

    Vectorized fast path for the universal well-formed "a|b" case; scalar
    fallback only when a column contains malformed / ragged cells.
    """
    n = len(cells)
    try:
        part = np.char.partition(cells, "|")
        rest = part[:, 2]
        if (rest == "").any():
            raise ValueError("cell without '|'")
        a = part[:, 0].astype(float)
        total = a.copy()
        b = None
        cur = rest
        while True:
            p = np.char.partition(cur, "|")
            tok, cur = p[:, 0], p[:, 2]
            if (tok == "").any():
                raise ValueError("empty field")
            vals = tok.astype(float)
            if b is None:
                b = vals
            total = total + vals
            if (cur == "").all():
                break
            if (cur == "").any():
                raise ValueError("ragged field counts")
        return a, b, total, np.ones(n, bool)
    except ValueError:
        pass
    a = np.full(n, np.nan)
    b = np.full(n, np.nan)
    total = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    for i in range(n):
        try:
            fs = [float(x) for x in str(cells[i]).split("|")]
        except ValueError:
            continue
        if len(fs) < 2:
            continue
        a[i], b[i] = fs[0], fs[1]
        total[i] = sum(fs)
        ok[i] = True
    return a, b, total, ok


def _bootstrap_ci(x: List[float], bs: int, rng: np.random.Generator,
                  return_p: bool = False) -> List[float]:
    if len(x) > 0:
        arr = np.asarray(x, float)
        idx = rng.integers(0, len(arr), size=(bs, len(arr)))
        vals = np.median(arr[idx], axis=1)
        out = [float(np.percentile(vals, 2.5)), float(np.median(arr)),
               float(np.percentile(vals, 97.5))]
        if return_p:
            p = (min(int((vals > 0).sum()), int((vals < 0).sum())) / bs) * 2
            out.append(float(p))
        return out
    out = [float("nan")] * 3
    if return_p:
        out.append(float("nan"))
    return out


def _list_to_str(x, sep=",") -> str:
    return sep.join(map(str, x))


def _pop_warm_path() -> str:
    import os

    from ..utils.jaxtune import cache_dir
    return os.path.join(cache_dir(), "pop_warm.json")


def _pop_any_warm(bs: int) -> bool:
    """Any non-cpu backend marked warm for this bs — readable WITHOUT
    importing jax.  The auto gate must not pay device-runtime
    initialization just to decide to use numpy."""
    import json
    try:
        with open(_pop_warm_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return False
    sfx = ":%d" % bs
    return any(k.endswith(sfx) and not k.startswith("cpu:") and bool(v)
               for k, v in data.items())


def _pop_is_warm(backend: str, bs: int) -> bool:
    """Has a device bootstrap for (backend, bs) completed on this machine
    before?  If so its shape buckets are in the persistent jit cache and
    the auto gate may use the warm crossover."""
    import json
    try:
        with open(_pop_warm_path()) as f:
            return bool(json.load(f).get("%s:%d" % (backend, bs)))
    except (OSError, ValueError):
        return False


def _pop_mark_warm(backend: str, bs: int) -> None:
    import json
    import os
    import tempfile
    try:
        path = _pop_warm_path()
        data = {}
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            pass
        data["%s:%d" % (backend, bs)] = True
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass


def run_cis_var(bed: str, vcf: str, pairs: str, sample_map: str, o: str,
                pc: int = 1, min_cov: int = 8, chrom: str = "",
                bs: int = 10000, ignore_v: int = 0, bs_seed: int = 0,
                engine: str = "auto", log=print) -> None:
    """engine='jax' batches all bootstrap draws in ONE device program +
    ONE device->host fetch (kernels.bootstrap); engine='auto' (default)
    picks jax when the bootstrap workload (pairs x draws) is large enough
    to amortize the fixed compile + transfer cost, numpy otherwise.

    Cross-engine determinism: point estimates, cohort lists, counts, and
    the rank-sum test are IDENTICAL between engines; the four CI
    lower/upper bounds and var_het_pval are engine-specific for the same
    --bs_seed (numpy: float64 per-pair seeded Generator index resampling;
    jax: float32 order-statistic sampling — statistically equivalent, not
    bitwise equal). Pin --engine for bitwise-reproducible CI columns.

    Warming a new host: auto only picks the device engine on a COLD cache
    at very large workloads (pairs*bs >= 64M), and a numpy run never warms
    the cache — so on a fresh machine with mid-size repeated runs, pin
    --engine jax once; every later auto run then uses the warm crossover
    (pairs*bs >= 8M)."""
    df_pairs_n = max(sum(1 for _ in open(pairs)) - 1, 0)
    if engine == "auto":
        # crossover in pairs*bs between the vectorized numpy bootstrap
        # (no fixed cost) and the device bootstrap (fixed runtime init +
        # compile, then cheap per pair): 8M with a warm persistent compile
        # cache, 64M with a cold one, where every (batch, cohort-pow2)
        # bucket compiles first. These constants predate the GPU port and
        # are to be re-derived from H100 traces (ROADMAP S5). Whether THIS
        # run is warm is read from a sidecar marker next to the persistent
        # compile cache, written after the first successful device
        # bootstrap per (backend, bs).
        engine = "numpy"
        if df_pairs_n * bs >= 8_000_000:
            cold_ok = df_pairs_n * bs >= 64_000_000
            # decide from the sidecar marker BEFORE importing jax:
            # jax.default_backend() initializes the device runtime, which
            # must not be paid on runs the gate resolves to numpy anyway
            if cold_ok or _pop_any_warm(bs):
                import jax
                backend = jax.default_backend()
                if backend != "cpu" and (
                        cold_ok or _pop_is_warm(backend, bs)):
                    engine = "jax"
    df_map = pd.read_csv(sample_map, sep="\t", index_col=False)
    dict_map = dict(zip(df_map["vcf_sample"], df_map["bed_sample"]))

    df_pairs = pd.read_csv(pairs, sep="\t", index_col=False)
    if ignore_v == 1:
        df_pairs["gene_id"] = [x.split(".")[0] for x in df_pairs["gene_id"]]
    if chrom != "":
        df_pairs["var_contig"] = list(map(str, df_pairs["var_contig"]))
        df_pairs = df_pairs[df_pairs.var_contig == chrom]

    # load matrix rows for needed genes (reference filters lines by gene)
    raw = bgzf.read_text_auto(bed).decode() if bed.endswith(".gz") else \
        open(bed).read()
    set_use_genes = set(df_pairs["gene_id"].tolist())
    use_lines = []
    for xline in raw.splitlines():
        if xline.startswith("#"):
            use_lines.append(xline)
            continue
        xcols = xline.split("\t")
        name = xcols[3]
        if ignore_v == 1 and name.split(".")[0] in set_use_genes:
            use_lines.append(xline)
        elif name in set_use_genes:
            use_lines.append(xline)
    import io as _io
    df_phaser = pd.read_csv(_io.StringIO("\n".join(use_lines)), sep="\t")
    df_phaser.index = df_phaser["name"]
    if ignore_v == 1:
        df_phaser.index = [x.split(".")[0] for x in df_phaser.index]
    if len(df_phaser.index) == 0:
        raise RuntimeError("no phASER data read from input")

    tf = tabix.TabixFile(vcf)
    # VCF column names
    header_cols: List[str] = []
    for line in bgzf.read_text_auto(vcf).decode().splitlines():
        if line.startswith("#CHROM"):
            header_cols = line.lstrip("#").split("\t")
            break

    # ---- hoisted per-run metadata (the reference recomputes all of this
    # per pair x per sample): samples usable for EVERY record are the
    # dict_map entries present in both the VCF header and the matrix
    col_of = {name: i for i, name in enumerate(header_cols)}
    use_samples = [s for s in dict_map
                   if s in col_of and dict_map[s] in df_phaser.columns]
    vcf_cols = [col_of[s] for s in use_samples]
    # gene -> matrix row position (index is unique in valid matrices; the
    # reference's .loc would misbehave identically on duplicates)
    gene_row_of: Dict = {}
    for i, g in enumerate(df_phaser.index):
        if g not in gene_row_of:
            gene_row_of[g] = i
    gene_names = df_phaser["name"].tolist()
    # parse every used "aCount|bCount" cell exactly once (matrix lines were
    # pre-filtered to genes referenced by the pairs table, so no unused row
    # is parsed); min_cov sums ALL |-fields like the reference's
    # sum(counts) (phaser_cis_var.py:143-144)
    n_genes = len(df_phaser.index)
    n_use = len(use_samples)
    cnt_a = np.empty((n_genes, n_use), float)
    cnt_b = np.empty_like(cnt_a)
    cov_ok_all = np.zeros((n_genes, n_use), bool)
    for j, s in enumerate(use_samples):
        cells = np.asarray(df_phaser[dict_map[s]].astype(str).tolist(),
                           dtype="U")
        a, b, total, ok = _parse_count_cells(cells)
        cnt_a[:, j] = a
        cnt_b[:, j] = b
        cov_ok_all[:, j] = ok & (total >= min_cov)

    results = []
    pending = []  # jax engine: bootstrap all pairs in one batched dispatch
    for xindex in df_pairs.index:
        row_test = df_pairs.loc[xindex]
        grow = gene_row_of.get(row_test["gene_id"])
        if grow is None:
            continue
        var_pos = int(row_test["var_pos"])
        var_chr = str(row_test["var_contig"])
        for rec_line in tf.fetch(var_chr, var_pos - 1, var_pos):
            fields = rec_line.split("\t")
            if int(fields[1]) != var_pos:
                continue
            match = ((str(row_test.get("var_ref", "")) != "" and
                      str(row_test.get("var_alt", "")) != "" and
                      fields[3] == row_test["var_ref"] and
                      fields[4] == row_test["var_alt"]) or
                     fields[2] == row_test["var_id"])
            if not match:
                continue
            gt_index = fields[8].split(":").index("GT")
            gts = [fields[ci].split(":")[gt_index]
                   if ci < len(fields) else "" for ci in vcf_cols]
            # dtype pinned: np.asarray([]) without it is float64 and
            # np.char.* would raise on records with zero usable samples
            # (the reference simply yields empty cohorts there)
            g_arr = np.asarray(gts, dtype="U")
            phased = np.char.find(g_arr, "|") >= 0
            has0 = np.char.find(g_arr, "0") >= 0
            has1 = np.char.find(g_arr, "1") >= 0
            is_het = has0 & has1
            is_hom = (np.char.count(g_arr, "0") == 2) | \
                     (np.char.count(g_arr, "1") == 2)
            elig = phased & cov_ok_all[grow] & (is_het | is_hom)
            ca, cb = cnt_a[grow], cnt_b[grow]

            afcs = [[], []]
            phaser_counts = [[[], []], [[], []]]
            ids = [[], []]
            for j in np.flatnonzero(elig):
                xgt = gts[j]
                c0, c1 = ca[j], cb[j]
                afc = math.log((c0 + pc) / (c1 + pc), 2)
                if is_het[j]:
                    alt_index = xgt.split("|").index("1")
                    if alt_index == 1:
                        afc *= -1
                    afcs[0].append(afc)
                    ids[0].append(use_samples[j])
                    phaser_counts[0][0].append(
                        int((c0, c1)[int(not alt_index)]))
                    phaser_counts[0][1].append(int((c0, c1)[alt_index]))
                else:
                    afcs[1].append(afc)
                    ids[1].append(use_samples[j])
                    phaser_counts[1][0].append(int(c0))
                    phaser_counts[1][1].append(int(c1))

            abs_afcs = [list(map(abs, afcs[0])), list(map(abs, afcs[1]))]
            if engine == "jax":
                pending.append(dict(
                    xindex=xindex, name=gene_names[grow],
                    var_id=row_test["var_id"], var_chr=var_chr,
                    var_pos=var_pos, afcs=afcs, abs_afcs=abs_afcs,
                    phaser_counts=phaser_counts, ids=ids))
                continue
            rng = np.random.default_rng([bs_seed, int(xindex)])
            het_ci = _bootstrap_ci(afcs[0], bs, rng, True)
            het_abs_ci = _bootstrap_ci(abs_afcs[0], bs, rng)
            hom_ci = _bootstrap_ci(afcs[1], bs, rng)
            hom_abs_ci = _bootstrap_ci(abs_afcs[1], bs, rng)
            stat, pval = ranksums(abs_afcs[0], abs_afcs[1])
            results.append(
                [xindex, gene_names[grow], row_test["var_id"], var_chr,
                 var_pos, len(afcs[0]), len(afcs[1]), pval] + het_ci +
                het_abs_ci + hom_ci + hom_abs_ci +
                [_list_to_str(afcs[0]), _list_to_str(afcs[1]),
                 _list_to_str(phaser_counts[0][0]),
                 _list_to_str(phaser_counts[0][1]),
                 _list_to_str(phaser_counts[1][0]),
                 _list_to_str(phaser_counts[1][1]),
                 _list_to_str(ids[0]), _list_to_str(ids[1])])

    if engine == "jax" and pending:
        from ..kernels.bootstrap import bootstrap_cis_device
        cohorts = []
        for pdta in pending:
            cohorts += [np.asarray(pdta["afcs"][0], float),
                        np.asarray(pdta["abs_afcs"][0], float),
                        np.asarray(pdta["afcs"][1], float),
                        np.asarray(pdta["abs_afcs"][1], float)]
        cis = bootstrap_cis_device(cohorts, bs, seed=bs_seed)
        # device bootstrap completed: its shape buckets now sit in the
        # persistent jit cache — mark (backend, bs) warm so the next
        # auto-gated run uses the warm crossover
        import jax
        _pop_mark_warm(jax.default_backend(), bs)
        for k, pdta in enumerate(pending):
            het, het_abs, hom, hom_abs = cis[4 * k:4 * k + 4]

            def _mid(vals):
                return float(np.median(vals)) if len(vals) else float("nan")

            afcs, abs_afcs = pdta["afcs"], pdta["abs_afcs"]
            het_ci = [het[0], _mid(afcs[0]), het[1], het[2]]
            het_abs_ci = [het_abs[0], _mid(abs_afcs[0]), het_abs[1]]
            hom_ci = [hom[0], _mid(afcs[1]), hom[1]]
            hom_abs_ci = [hom_abs[0], _mid(abs_afcs[1]), hom_abs[1]]
            stat, pval = ranksums(abs_afcs[0], abs_afcs[1])
            pc_ = pdta["phaser_counts"]
            results.append(
                [pdta["xindex"], pdta["name"], pdta["var_id"],
                 pdta["var_chr"], pdta["var_pos"], len(afcs[0]), len(afcs[1]),
                 pval] + het_ci + het_abs_ci + hom_ci + hom_abs_ci +
                [_list_to_str(afcs[0]), _list_to_str(afcs[1]),
                 _list_to_str(pc_[0][0]), _list_to_str(pc_[0][1]),
                 _list_to_str(pc_[1][0]), _list_to_str(pc_[1][1]),
                 _list_to_str(pdta["ids"][0]), _list_to_str(pdta["ids"][1])])

    df_result = pd.DataFrame(results, columns=[
        "xindex", "gene", "var_id", "var_chr", "var_pos", "var_het_n",
        "var_hom_n", "het_hom_pvalue", "var_het_afc_lower", "var_het_afc",
        "var_het_afc_upper", "var_het_pval", "var_het_abs_afc_lower",
        "var_het_abs_afc", "var_het_abs_afc_upper", "var_hom_afc_lower",
        "var_hom_afc", "var_hom_afc_upper", "var_hom_abs_afc_lower",
        "var_hom_abs_afc", "var_hom_abs_afc_upper", "var_het_afcs",
        "var_hom_afcs", "var_het_ref_counts", "var_het_alt_counts",
        "var_hom_hap1_counts", "var_hom_hap2_counts", "var_het_sample_ids",
        "var_hom_sample_ids"])
    df_result = df_result.sort_values(by=["xindex"]).drop(["xindex"], axis=1)
    df_result.to_csv(o, sep="\t", index=False)
