#!/bin/bash
# Position-sharded multi-process run of the FULL phasing engine.
#
# Each process runs the complete pipeline on a weight-balanced
# (contig, position-range) shard of the BAM (planned from its .bai), with
# the global merge points (AS-score quantile, noise estimate, row
# sequencing, block indices, cross-shard row exchange) going through
# jax.distributed collectives; rank 0 assembles output files BYTE-IDENTICAL
# to a single-process run.
#
# On one machine (collectives over loopback Gloo):
#   bash examples/multihost_example.sh sample.vcf.gz sample.bam SAMPLE1 out 2
#
# On several hosts: launch the same command once per host with
# --platform '' (keep JAX's default platform), --device auto (per-process
# accelerator via mapper.dispatch), process-id = the host index, and a
# coordinator address reachable from every host.
#
# FAILURE RECOVERY: every shard journals its collective payloads to
# <out>.shardK.ckpt the moment its engine run completes. If the job dies
# (a host crash, a lost rank), relaunch the SAME command with RESUME=1:
# completed shards replay their journals (no recompute) and only the lost
# shards run again — merged outputs stay byte-identical.
set -euo pipefail
VCF=${1:?vcf.gz}; BAM=${2:?bam}; SAMPLE=${3:?sample}; OUT=${4:?out-prefix}
N=${5:-2}
PORT=$(( 9000 + RANDOM % 2000 ))

pids=()
for (( pid=0; pid<N; pid++ )); do
  python -m phaser_tpu.dist.engine_multihost \
    --vcf "$VCF" --bam "$BAM" --sample "$SAMPLE" --o "$OUT" \
    --num-processes "$N" --process-id "$pid" \
    --position-shards ${RESUME:+--resume} \
    --coordinator "localhost:$PORT" &
  pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; done
echo "merged outputs at: $OUT.*"
