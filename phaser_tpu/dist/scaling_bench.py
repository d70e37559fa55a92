"""Scaling-efficiency harness for the sharded phasing step.

BASELINE.json's multi-host target is >=80% scaling efficiency at 2 hosts.
This harness measures it: for each device count N it runs the sharded
allele-assignment + psum-merge step (dist.mesh.sharded_allele_counts) with
a FIXED per-device read batch (weak scaling) and reports

    efficiency(N) = throughput(N) / (N * throughput(1))

Each N runs in its own subprocess so the device count can be configured at
JAX init (xla_force_host_platform_device_count for the virtual CPU mesh).
Every child is pinned to the CPU platform: the harness starts one process
per N, and several processes must never share one GPU.

CAVEAT (single-chip environments): virtual CPU "devices" share the same
physical cores, so virtual-mesh efficiency is a LOWER bound dominated by
host oversubscription — it validates the collective program and measures
its overhead, not interconnect scaling.

Usage:
    python -m phaser_tpu.dist.scaling_bench [--devices 1,2,4,8]
        [--reads-per-device 2048] [--read-len 128] [--variants 512]
        [--iters 8]

Prints ONE JSON line:
    {"metric": "weak_scaling_efficiency", "value": eff_at_max,
     "unit": "fraction", "per_device": {...}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _gen(n_reads: int, read_len: int, n_vars: int, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    span = max(4 * read_len, n_vars * 8)
    codes = rng.integers(0, 16, (n_reads, read_len)).astype(np.uint8)
    quals = rng.integers(0, 42, (n_reads, read_len)).astype(np.uint8)
    start = rng.integers(1, span, n_reads).astype(np.int32)
    refpos = start[:, None] + np.arange(read_len, dtype=np.int32)[None, :]
    vpos = np.sort(rng.choice(np.arange(1, span + read_len), n_vars,
                              replace=False)).astype(np.int32)
    ind = rng.integers(1, 15, (n_vars, 2)).astype(np.uint8)
    ni = np.full(n_vars, 2, np.int8)
    return codes, quals, refpos, vpos, ind, ni


def run_child(n_devices: int, reads_per_device: int, read_len: int,
              n_vars: int, iters: int, baseq: int = 10) -> dict:
    import jax
    # config as well as JAX_PLATFORMS: the child may be imported into a
    # process whose environment names another platform
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from .mesh import make_mesh, shard_reads, sharded_allele_counts

    if len(jax.devices()) < n_devices:
        raise RuntimeError("only %d devices visible, need %d"
                           % (len(jax.devices()), n_devices))
    mesh = make_mesh(n_devices)
    n_reads = reads_per_device * n_devices
    codes, quals, refpos, vpos, ind, ni = _gen(n_reads, read_len, n_vars)
    codes, quals, refpos = shard_reads(mesh, codes, quals, refpos)

    counts = sharded_allele_counts(mesh, codes, quals, refpos, vpos, ind,
                                   ni, baseq)
    jax.block_until_ready(counts)  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        counts = sharded_allele_counts(mesh, codes, quals, refpos, vpos,
                                       ind, ni, baseq)
    jax.block_until_ready(counts)
    dt = (time.perf_counter() - t0) / iters
    total = int(np.asarray(counts).sum())
    return {"n_devices": n_devices, "reads": n_reads, "step_s": dt,
            "reads_per_s": n_reads / dt, "hits": total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--reads-per-device", type=int, default=2048)
    ap.add_argument("--read-len", type=int, default=128)
    ap.add_argument("--variants", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--child", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        res = run_child(args.child, args.reads_per_device, args.read_len,
                        args.variants, args.iters)
        print("CHILD_RESULT " + json.dumps(res))
        return 0

    device_counts = [int(x) for x in args.devices.split(",")]
    per: dict = {}
    for n in device_counts:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=%d"
                            % n).strip()
        cmd = [sys.executable, "-m", "phaser_tpu.dist.scaling_bench",
               "--child", str(n),
               "--reads-per-device", str(args.reads_per_device),
               "--read-len", str(args.read_len),
               "--variants", str(args.variants),
               "--iters", str(args.iters)]
        cp = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=900)
        if cp.returncode != 0:
            sys.stderr.write(cp.stderr[-2000:])
            raise RuntimeError("child for %d devices failed" % n)
        line = [l for l in cp.stdout.splitlines()
                if l.startswith("CHILD_RESULT ")][-1]
        per[n] = json.loads(line[len("CHILD_RESULT "):])

    base = per[device_counts[0]]["reads_per_s"] / device_counts[0]
    for n, r in per.items():
        r["efficiency"] = r["reads_per_s"] / (n * base)
    n_max = max(device_counts)
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": round(per[n_max]["efficiency"], 4),
        "unit": "fraction",
        "per_device": per,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
