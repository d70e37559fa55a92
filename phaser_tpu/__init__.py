"""phaser_tpu — read-backed phasing + allele-specific expression in JAX, for
an NVIDIA GPU (H100) or the CPU.

A ground-up reimplementation of the capabilities of secastel/phaser
(read-backed haplotype phasing + ASE from RNA/DNA BAMs and a genotype VCF,
through gene-level AE, compound-het annotation, and population-scale
cis-regulatory effect sizes), designed for an accelerator:

- Host data plane: own BGZF/BAM/VCF/tabix codecs (C++ fast path, pure-Python
  fallback) emitting fixed-width integer tensors.  No samtools/pysam/tabix
  subprocesses (reference shells out: /root/reference/phaser/phaser.py:97-101).
- Device compute: read→variant allele assignment, variant-connection pair
  counts, binomial noise tests, connected components, and exhaustive 2^K
  block-phase scoring run as vectorized JAX/XLA kernels.
- Scale-out: genomic-coordinate sharding over a jax.sharding.Mesh with
  psum/all_gather merges of per-shard count tensors.

Output files are format- and value-compatible with phASER v1.2.0.
"""

from .version import __version__  # noqa: F401
