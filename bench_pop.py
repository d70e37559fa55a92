"""phASER-POP scale benchmark: samples/s (expr_matrix) and pairs/s (cis_var).

BASELINE.json config 5 is "phaser_pop at GTEx scale: expression matrix +
cis_var across hundreds of samples". This synthesizes that shape directly —
S gene-AE sample files x G genes for the matrix stage, and an S-sample
genotype VCF + matrix for P (gene, variant) pairs of aFC inference with the
full 10,000-draw bootstrap — and measures throughput of each stage.

Prints ONE JSON line:
  {"metric": "pop_samples_per_s", "value": N, "unit": "samples/s",
   "cis_var_pairs_per_s": N, ...}

Sizes via env: POP_SAMPLES (300), POP_GENES (2000), POP_PAIRS (60),
POP_BS (10000).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

S = int(os.environ.get("POP_SAMPLES", 300))
G = int(os.environ.get("POP_GENES", 2000))
P = int(os.environ.get("POP_PAIRS", 60))
BS = int(os.environ.get("POP_BS", 10000))


def make_gene_ae_dir(tmp, rng):
    d = os.path.join(tmp, "gene_ae")
    os.makedirs(d, exist_ok=True)
    header = "\t".join(["contig", "start", "stop", "name", "aCount",
                        "bCount", "totalCount", "log2_aFC", "n_variants",
                        "variants", "gw_phased", "bam"])
    genes = ["ENSG%06d.1" % i for i in range(G)]
    starts = 1000 + 2000 * np.arange(G)
    features = os.path.join(tmp, "features.bed")
    with open(features, "w") as f:
        for g, st in zip(genes, starts):
            f.write("chr20\t%d\t%d\t%s\n" % (st, st + 1500, g))
    for si in range(S):
        a = rng.integers(0, 40, G)
        b = rng.integers(0, 40, G)
        gw = rng.integers(0, 2, G)
        rows = [header]
        for gi in range(G):
            rows.append("chr20\t%d\t%d\t%s\t%d\t%d\t%d\t0.0\t2\tv1,v2\t%d\tS%03d"
                        % (starts[gi], starts[gi] + 1500, genes[gi], a[gi],
                           b[gi], a[gi] + b[gi], gw[gi], si))
        with open(os.path.join(d, "sample%03d.txt" % si), "w") as f:
            f.write("\n".join(rows) + "\n")
    return d, features, genes, starts


def make_cis_var_inputs(tmp, rng, matrix_path):
    from phaser_tpu.io import bgzf, tabix
    vs = ["S%03d" % i for i in range(S)]
    map_path = os.path.join(tmp, "sample_map.txt")
    with open(map_path, "w") as f:
        f.write("vcf_sample\tbed_sample\n")
        for v in vs:
            f.write("%s\t%s\n" % (v, v))
    # cycle genes when P > G so every pair resolves to a matrix row (no
    # silently-dropped pairs inflating the rate)
    genes = ["ENSG%06d.1" % (i % G) for i in range(P)]
    vcf_rows = ["##fileformat=VCFv4.2",
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" +
                "\t".join(vs)]
    pair_rows = ["gene_id\tvar_id\tvar_contig\tvar_pos\tvar_ref\tvar_alt"]
    for vi in range(P):
        pos = 1200 + vi * 2000
        gts = ["%d|%d" % (rng.integers(0, 2), rng.integers(0, 2))
               for _ in range(S)]
        vcf_rows.append("chr20\t%d\tvar%d\tA\tG\t100\tPASS\t.\tGT\t%s"
                        % (pos, vi, "\t".join(gts)))
        pair_rows.append("%s\tvar%d\tchr20\t%d\tA\tG" % (genes[vi], vi, pos))
    vcf_path = os.path.join(tmp, "pop.vcf.gz")
    bgzf.compress_to_path(("\n".join(vcf_rows) + "\n").encode(), vcf_path)
    tabix.build_vcf_index(vcf_path)
    pairs_path = os.path.join(tmp, "pairs.txt")
    with open(pairs_path, "w") as f:
        f.write("\n".join(pair_rows) + "\n")
    return vcf_path, pairs_path, map_path


def make_hap_counts(tmp, rng, genes, starts, blocks_per_gene=3,
                    vars_per_block=4, reads_per_var=8):
    """Synthetic engine haplotypic_counts output at G x blocks_per_gene
    rows — the INPUT of phaser_gene_ae (the stage bench_pop previously
    used only as a fixture, never timed)."""
    path = os.path.join(tmp, "hap_counts.txt")
    cols = ["contig", "start", "stop", "variants", "variantCount",
            "variantsBlacklisted", "variantCountBlacklisted", "haplotypeA",
            "haplotypeB", "aCount", "bCount", "totalCount", "blockGWPhase",
            "gwStat", "max_haplo_maf", "bam", "aReads", "bReads"]
    rid = 0
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for gi, st in enumerate(starts):
            for b in range(blocks_per_gene):
                vpos = sorted(rng.integers(st, st + 1500, vars_per_block)
                              .tolist())
                variants = ",".join("chr20_%d_A_G" % p for p in vpos)
                a_segs, b_segs = [], []
                sa, sb = set(), set()
                for _ in vpos:
                    ia = [str(rid + k) for k in
                          range(int(rng.integers(1, reads_per_var)))]
                    rid += len(ia)
                    ib = [str(rid + k) for k in
                          range(int(rng.integers(1, reads_per_var)))]
                    rid += len(ib)
                    a_segs.append(",".join(ia))
                    b_segs.append(",".join(ib))
                    sa.update(ia)
                    sb.update(ib)
                gwph = "0|1" if rng.integers(0, 2) else "1|0"
                f.write("\t".join(map(str, [
                    "chr20", vpos[0], vpos[-1], variants, len(vpos), "", 0,
                    ",".join("A" for _ in vpos), ",".join("G" for _ in vpos),
                    len(sa), len(sb), len(sa) + len(sb), gwph, "1.0", "0.3",
                    "pop", ";".join(a_segs), ";".join(b_segs)])) + "\n")
    return path


def bench_cold_auto(tmp, bed, vcf_path, pairs_path, map_path, n_pairs):
    """Cold-cache like-for-like: run engine='auto' AND engine='numpy' each
    in a fresh SUBPROCESS with a fresh persistent jit cache + warm marker
    (identical measurement conditions). The cold-aware gate must pick
    numpy below the cold crossover, so cold auto tracks the numpy time.
    Returns (auto_s, numpy_s)."""
    import subprocess
    import sys as _sys
    sub_pairs = os.path.join(tmp, "pairs_cold_%d.txt" % n_pairs)
    with open(pairs_path) as f:
        pl = f.read().splitlines()
    with open(sub_pairs, "w") as f:
        f.write("\n".join(pl[:n_pairs + 1]) + "\n")
    def one(engine, rep):
        cold_dir = os.path.join(tmp, "cold_jit_%d_%s_%d"
                                % (n_pairs, engine, rep))
        os.makedirs(cold_dir, exist_ok=True)
        script = (
            "import sys, time\n"
            "sys.path.insert(0, %r)\n"
            "from phaser_tpu.analysis.cis_var import run_cis_var\n"
            "t0 = time.perf_counter()\n"
            "run_cis_var(%r, %r, %r, %r, %r, bs=%d, bs_seed=7, "
            "engine=%r)\n"
            "print('COLD_S %%.3f' %% (time.perf_counter() - t0))\n"
            % (os.path.dirname(os.path.abspath(__file__)), bed, vcf_path,
               sub_pairs, map_path,
               os.path.join(tmp, "cold_%d_%s.txt" % (n_pairs, engine)),
               BS, engine))
        env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cold_dir)
        proc = subprocess.run([_sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=3600)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr[-2000:])
        line = [l for l in proc.stdout.splitlines()
                if l.startswith("COLD_S")][0]
        return float(line.split()[1])

    # short runs are dominated by OS-level order effects (first subprocess
    # after a device-heavy leg pays page-cache churn): interleave and take
    # the best per engine; run-to-run spread is returned so the artifact
    # shows the variance behind the headline (round-4 verdict #7)
    reps = 2 if n_pairs <= 100 else 2
    auto_reps = [one("auto", r) for r in range(reps)]
    np_reps = [one("numpy", r) for r in range(reps)]
    return auto_reps, np_reps


def main():
    import tempfile
    from phaser_tpu.analysis.cis_var import run_cis_var
    from phaser_tpu.analysis.expr_matrix import run_expr_matrix
    from phaser_tpu.analysis.gene_ae import run_gene_ae

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        d, features, genes, starts = make_gene_ae_dir(tmp, rng)

        # timed gene_ae stage (G x 3 blocks input rows)
        hap_counts = make_hap_counts(tmp, rng, genes, starts)
        n_hc = sum(1 for _ in open(hap_counts)) - 1
        t0 = time.perf_counter()
        run_gene_ae(hap_counts, features, os.path.join(tmp, "ae_out.txt"),
                    log=lambda *a: None)
        t_gene_ae = time.perf_counter() - t0

        mat = os.path.join(tmp, "matrix")
        t0 = time.perf_counter()
        run_expr_matrix(d, features, mat, log=lambda *a: None)
        t_matrix = time.perf_counter() - t0

        vcf_path, pairs_path, map_path = make_cis_var_inputs(
            tmp, rng, mat + ".gw_phased.bed.gz")
        # forced-jax FIRST: warms + marks the persistent cache, so the
        # auto headline below reflects a warm production host (cold-cache
        # behavior is measured separately in cold_auto)
        out_jax = os.path.join(tmp, "cis_var_jax.txt")
        t0 = time.perf_counter()
        run_cis_var(mat + ".gw_phased.bed.gz", vcf_path, pairs_path,
                    map_path, out_jax, bs=BS, bs_seed=7, engine="jax")
        t_jax = time.perf_counter() - t0

        # headline: engine="auto" — what users get (cold-aware crossover
        # gate between the numpy path and the batched device bootstrap)
        out = os.path.join(tmp, "cis_var.txt")
        t0 = time.perf_counter()
        run_cis_var(mat + ".gw_phased.bed.gz", vcf_path, pairs_path,
                    map_path, out, bs=BS, bs_seed=7, engine="auto")
        t_cis = time.perf_counter() - t0
        n_out = sum(1 for _ in open(out)) - 1

        # numpy-engine comparison floor, on a subset when P is large (the
        # per-pair numpy bootstrap rate is flat, so the subset rate is the
        # full-run rate)
        np_pairs = min(P, int(os.environ.get("POP_NUMPY_PAIRS", "30")))
        with open(pairs_path) as f:
            pl = f.read().splitlines()
        sub_pairs = os.path.join(tmp, "pairs_sub.txt")
        with open(sub_pairs, "w") as f:
            f.write("\n".join(pl[:np_pairs + 1]) + "\n")
        out_np = os.path.join(tmp, "cis_var_np.txt")
        t0 = time.perf_counter()
        run_cis_var(mat + ".gw_phased.bed.gz", vcf_path, sub_pairs,
                    map_path, out_np, bs=BS, bs_seed=7, engine="numpy")
        t_np = time.perf_counter() - t0
        np_rate = np_pairs / t_np

        # COLD-cache auto gate (round-3 weakness: the old gate made cold
        # P=2000 a 3x loss): auto and numpy both in fresh subprocesses
        # with fresh jit caches + warm markers; auto must track numpy
        # at P in {30, 2000}
        cold = {}
        for pc in (30, 2000):
            pn = min(pc, P)
            auto_reps, np_reps = bench_cold_auto(
                tmp, mat + ".gw_phased.bed.gz", vcf_path, pairs_path,
                map_path, pn)
            t_cold, t_np_cold = min(auto_reps), min(np_reps)
            cold["P%d" % pc] = {
                "pairs": pn, "auto_cold_s": round(t_cold, 3),
                "auto_cold_reps_s": [round(x, 3) for x in auto_reps],
                "auto_cold_pairs_per_s": round(pn / t_cold, 2),
                "numpy_cold_s": round(t_np_cold, 3),
                "numpy_cold_reps_s": [round(x, 3) for x in np_reps],
                "numpy_cold_pairs_per_s": round(pn / t_np_cold, 2),
                # a cold auto run that resolves to numpy must cost no more
                # than the marker-file read over numpy itself
                "auto_not_slower": t_cold <= 1.05 * t_np_cold,
            }

    payload = {
        "metric": "pop_samples_per_s",
        "value": round(S / t_matrix, 2),
        "unit": "samples/s",
        "samples": S, "genes": G,
        "matrix_s": round(t_matrix, 3),
        "cis_var_pairs_per_s": round(n_out / t_cis, 2),
        "cis_var_engine": "auto",
        "cis_var_jax_pairs_per_s": round(n_out / t_jax, 2),
        "cis_var_numpy_pairs_per_s": round(np_pairs / t_np, 2),
        "cis_var_numpy_pairs": np_pairs,
        "cis_var_pairs": n_out,
        "cis_var_bs": BS,
        "cis_var_s": round(t_cis, 3),
        "cis_var_jax_s": round(t_jax, 3),
        "cis_var_numpy_s": round(t_np, 3),
        "gene_ae_s": round(t_gene_ae, 3),
        "gene_ae_rows": n_hc,
        "gene_ae_rows_per_s": round(n_hc / t_gene_ae, 1),
        "cold_auto": cold,
    }
    print(json.dumps(payload))
    out_json = os.environ.get("POP_BENCH_OUT", "")
    if out_json:
        with open(out_json, "w") as f:
            json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
