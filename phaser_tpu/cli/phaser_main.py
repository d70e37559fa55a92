"""phaser_tpu main CLI — flag-compatible with the reference phaser.py
(/root/reference/phaser/phaser.py:26-81), so reference command lines run
unchanged (minus the external-tool requirements, which no longer exist).
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time

from ..engine.output_stage import PhaserOptions
from ..engine.pipeline import run_phaser
from ..version import PHASER_COMPAT_VERSION, __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phaser")
    p.add_argument("--bam", required=False, default="")
    p.add_argument("--vcf", required=True, default="")
    p.add_argument("--sample", required=False, default="")
    p.add_argument("--mapq", required=True)
    p.add_argument("--baseq", type=int, required=True)
    p.add_argument("--paired_end", required=True)
    p.add_argument("--o", required=True)
    p.add_argument("--python_string", default="python3")          # accepted, unused
    p.add_argument("--haplo_count_bam_exclude", default="")
    p.add_argument("--haplo_count_blacklist", default="")
    p.add_argument("--cc_threshold", type=float, default=0.01)
    p.add_argument("--isize", default="0")
    p.add_argument("--as_q_cutoff", type=float, default=0.05)
    p.add_argument("--blacklist", default="")
    p.add_argument("--write_vcf", type=int, default=1)
    p.add_argument("--include_indels", type=int, default=0)
    p.add_argument("--output_read_ids", type=int, default=0)
    p.add_argument("--remove_dups", type=int, default=1)
    p.add_argument("--pass_only", type=int, default=1)
    p.add_argument("--unphased_vars", type=int, default=1)
    p.add_argument("--chr_prefix", type=str, default="")
    p.add_argument("--gw_phase_method", type=int, default=0)
    p.add_argument("--gw_af_field", default="AF")
    p.add_argument("--gw_phase_vcf", type=int, default=0)
    p.add_argument("--gw_phase_vcf_min_confidence", type=float, default=0.90)
    p.add_argument("--threads", type=int, default=1,
                   help="Thread the per-contig host stages (mapper, "
                        "accumulate, connections); reference semantics "
                        "phaser.py:2077-2094.")
    p.add_argument("--max_block_size", type=int, default=15)
    p.add_argument("--temp_dir", default="")
    p.add_argument("--max_items_per_thread", type=int, default=100000)
    p.add_argument("--show_warning", type=int, default=0)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--chr", default="")
    p.add_argument("--unique_ids", type=int, default=0)
    p.add_argument("--id_separator", default="_")
    p.add_argument("--output_network", default="")
    p.add_argument("--process_slow", type=int, default=0)         # accepted; engine streams
    p.add_argument("--resume", type=int, default=0,
                   help="Reuse completed work from a failed previous run: "
                        "with --process_slow 1, skip contigs whose outputs "
                        "exist; with --threads N (multiprocess), replay "
                        "completed shards' journals and recompute only "
                        "lost shards (phaser_tpu extension).")
    p.add_argument("--device", default="auto", choices=("auto", "gpu", "host"),
                   help="Compute device for hot kernels: auto = JAX's default "
                        "backend, gpu = the GPU or fail, host = numpy/C++ "
                        "only (phaser_tpu extension).")
    return p


def _require_gpu() -> None:
    """--device gpu: the device kernels must run on a GPU, never elsewhere."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError("--device gpu: JAX found no GPU (default device "
                           "is %s, platform %r)" % (dev, dev.platform))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print("")
    print("##################################################")
    print("       phaser_tpu v%s (phASER v%s compatible)"
          % (__version__, PHASER_COMPAT_VERSION))
    print("   read-backed phasing + ASE engine (JAX, GPU)")
    print("##################################################")
    print("")
    start = time.time()
    print('STARTED "Read backed phasing and ASE/haplotype analyses" ... ')
    print("    DATE, TIME : %s"
          % datetime.datetime.now().strftime("%Y-%m-%d, %H:%M:%S"))

    opts = PhaserOptions(
        id_separator=args.id_separator, unique_ids=args.unique_ids,
        gw_phase_method=args.gw_phase_method,
        output_read_ids=args.output_read_ids,
        output_network=args.output_network,
        unphased_vars=args.unphased_vars, max_block_size=args.max_block_size,
        cc_threshold=args.cc_threshold, as_q_cutoff=args.as_q_cutoff,
        pass_only=args.pass_only, include_indels=args.include_indels,
        remove_dups=args.remove_dups, write_vcf=args.write_vcf,
        gw_phase_vcf=args.gw_phase_vcf,
        gw_phase_vcf_min_confidence=args.gw_phase_vcf_min_confidence,
        gw_af_field=args.gw_af_field, chr_prefix=args.chr_prefix,
        show_warning=args.show_warning)
    device = "host" if args.device == "host" else "auto"
    kwargs = dict(
        vcf=args.vcf, bam=args.bam, sample=args.sample, o=args.o,
        mapq=args.mapq, baseq=args.baseq, paired_end=args.paired_end,
        isize=args.isize, blacklist=args.blacklist,
        haplo_count_blacklist=args.haplo_count_blacklist,
        haplo_count_bam_exclude=args.haplo_count_bam_exclude)
    if args.process_slow == 1:
        from ..engine.slow_mode import run_phaser_slow
        import functools
        _run = functools.partial(run_phaser_slow, resume=bool(args.resume),
                                 chrom=args.chr, opts=opts,
                                 threads=max(1, args.threads),
                                 device=device)
    elif args.threads > 1 and device == "host":
        # TRUE parallelism: N position-sharded engine processes with
        # collective merges (the reference forks a pool capped at one
        # worker per contig, phaser.py:62,2077-2094); outputs stay
        # byte-identical to a single-process run
        from ..dist.engine_multihost import run_phaser_multiproc
        import functools
        _run = functools.partial(run_phaser_multiproc,
                                 max(1, args.threads), chrom=args.chr,
                                 opts=opts, device=device,
                                 resume=bool(args.resume))
    elif args.threads > 1:
        # default --device auto: N position-sharded engine THREADS sharing
        # the one local accelerator (JAX dispatch is thread-safe; packer
        # scratch is thread-local) — separate processes would contend for
        # the chip. Outputs stay byte-identical (test_threads.py).
        from ..dist.engine_multihost import run_phaser_sharded_threads
        import functools
        _run = functools.partial(run_phaser_sharded_threads,
                                 n_shards=max(1, args.threads),
                                 chrom=args.chr, opts=opts, device=device,
                                 position_shards=True)
    else:
        import functools
        _run = functools.partial(run_phaser, chrom=args.chr, opts=opts,
                                 threads=max(1, args.threads),
                                 device=device)
    try:
        if args.device == "gpu":
            _require_gpu()
        _run(**kwargs)
    except (ValueError, RuntimeError, FileNotFoundError) as e:
        from ..utils.failures import write_failure_record
        record = write_failure_record(args.o, "phaser", e, argv)
        print("     FATAL ERROR: %s" % e)
        if record:
            print("     failure record: %s" % record)
        return 1
    from ..utils.failures import clear_failure_record
    clear_failure_record(args.o)
    print('COMPLETED "Read backed phasing" of sample %s in %s hh:mm:ss'
          % (args.sample,
             time.strftime("%H:%M:%S", time.gmtime(time.time() - start))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
