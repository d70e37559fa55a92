"""Device bootstrap kernel for phASER-POP cis-var.

The reference draws 4 x 10,000 index resamples per (gene, variant) pair
serially with numpy and medians each resample
(/root/reference/phaser_pop/phaser_cis_var.py:202-219). Early phaser_tpu
versions ported that shape to the device (gather (B, bs, n) draws, masked
sort per draw) — O(bs * n log n) sorted elements per cohort, minutes of
compile + tens of seconds of run at GTEx scale.

This implementation samples the bootstrap median's ORDER STATISTICS in
closed form instead, which is distribution-exact and needs no per-draw data
movement at all:

  * a bootstrap resample draws n iid indices uniform on {0..n-1}, i.e.
    floor(n * U) with U ~ Uniform(0,1); floor is monotone, so the k-th order
    statistic of the indices is floor(n * U_(k));
  * U_(k) ~ Beta(k+1, n-k) — sampled directly;
  * the median needs the two middle order statistics k1=(n-1)//2, k2=n//2 of
    the SAME draw: conditional on U_(k1)=x, U_(k2) is the minimum of the
    remaining n-k1-1 uniforms above x: x + (1-x) * (1 - (1-u)^(1/(n-k1-1)));
  * each cohort is sorted ONCE; every draw is then two gathers.

Per draw that is O(1) work: (B, bs) beta/uniform samples + two
take_along_axis gathers — the whole 10,000-draw bootstrap for hundreds of
cohorts is a single sub-second device program.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("bs",))
def _bootstrap_medians(xs_sorted: jax.Array, n: jax.Array, key: jax.Array,
                       bs: int) -> jax.Array:
    """(B, bs) bootstrap medians via order-statistic inversion."""
    B, _ = xs_sorted.shape
    nf = n.astype(jnp.float32)
    k1 = (n - 1) // 2
    k2 = n // 2
    a = (k1 + 1).astype(jnp.float32)[:, None]
    b = (n - k1).astype(jnp.float32)[:, None]
    kx, ku = jax.random.split(key)
    x = jax.random.beta(kx, jnp.broadcast_to(a, (B, bs)),
                        jnp.broadcast_to(b, (B, bs)))
    u = jax.random.uniform(ku, (B, bs))
    m = jnp.maximum((n - k1 - 1).astype(jnp.float32), 1.0)[:, None]
    y = x + (1.0 - x) * (1.0 - (1.0 - u) ** (1.0 / m))
    y = jnp.where((k2 > k1)[:, None], y, x)
    hi_idx = (n - 1)[:, None]
    i1 = jnp.clip((x * nf[:, None]).astype(jnp.int32), 0, hi_idx)
    i2 = jnp.clip((y * nf[:, None]).astype(jnp.int32), 0, hi_idx)
    v1 = jnp.take_along_axis(xs_sorted, i1, axis=1)
    v2 = jnp.take_along_axis(xs_sorted, i2, axis=1)
    return 0.5 * (v1 + v2)


@functools.partial(jax.jit, static_argnames=("bs",))
def _median_tails(meds: jax.Array, bs: int):
    """One stacked (3, B) result [lower; upper; p] so the caller needs a
    SINGLE device->host fetch (as in mapper.dispatch.resolve_all)."""
    lower = jnp.percentile(meds, 2.5, axis=1)
    upper = jnp.percentile(meds, 97.5, axis=1)
    pos = (meds > 0).sum(axis=1)
    neg = (meds < 0).sum(axis=1)
    p = jnp.minimum(pos, neg) / bs * 2.0
    return jnp.stack([lower, upper, p])


def batched_bootstrap_median(xs_sorted: jax.Array, n: jax.Array,
                             key: jax.Array, bs: int):
    """Distribution-exact batched bootstrap medians via order-statistic
    inversion.

    xs_sorted: (B, Npad) cohorts sorted ascending with +inf padding.
    n: (B,) true cohort sizes (>= 1).
    Returns a stacked (3, B) device array [lower; upper; p] — the 2.5/97.5
    percentiles of bootstrap medians and the two-sided sign test of the
    median distribution vs 0. Stacked so one np.asarray fetches all three.

    Deliberately TWO device programs (sampler, then percentiles): fusing the
    gamma rejection-sampler while_loop with the percentile sort sent XLA's
    optimizer into a multi-minute compile on the CPU backend (241 s fused
    vs ~10 s split); the extra dispatch costs microseconds against that.
    """
    meds = _bootstrap_medians(xs_sorted, n, key, bs)
    return _median_tails(meds, bs)


def bootstrap_cis_device(cohorts: List[np.ndarray], bs: int,
                         seed: int = 0) -> List[Tuple[float, float, float]]:
    """Run ALL cohorts as one batched device bootstrap (single compile +
    single launch; pow2-padded batch and cohort dims).

    Returns (lower, upper, p) per cohort; empty cohorts give nans.

    PRNG contract: results are deterministic per (seed, bs, cohort set) but
    NOT stable across releases — the chunked-batch rework (fixed 2048-row
    bucket) made every run derive per-chunk keys via jax.random.split, so a
    given bs_seed yields different CI draws than pre-chunking releases
    (including single-chunk runs, which now use split(key)[1] rather than
    the root key). Documented contract is determinism per seed only.
    """
    from ..utils.jaxtune import enable_compile_cache
    enable_compile_cache()  # the compile is the cost; persist it across runs
    out: List[Tuple[float, float, float]] = [None] * len(cohorts)
    idxs = [i for i, c in enumerate(cohorts) if len(c)]
    for i, c in enumerate(cohorts):
        if not len(c):
            out[i] = (float("nan"), float("nan"), float("nan"))
    if not idxs:
        return out
    ns = np.array([len(cohorts[i]) for i in idxs], np.int32)
    Npad = _pow2(int(ns.max()))
    B = len(idxs)
    # Fixed 2048-row batch bucket: (a) bounds the gamma-sampler's temp
    # buffers (2.64 GB at 2048 rows x bs=10000 on an H100, from the compiled
    # sampler's memory_analysis; they grow linearly with rows x bs);
    # (b) every chunk of every run hits the SAME compiled program, so the
    # persisted compile cache amortizes the per-process AOT cost across
    # arbitrary pair counts. All chunks launch before the one fetch.
    Bp = min(_pow2(B), 2048)
    key = jax.random.key(seed)
    chunks = []
    for c0 in range(0, B, Bp):
        cidx = idxs[c0:c0 + Bp]
        X = np.full((Bp, Npad), np.inf, np.float32)
        n_arr = np.ones(Bp, np.int32)
        for k, i in enumerate(cidx):
            X[k, :len(cohorts[i])] = np.sort(cohorts[i])
            n_arr[k] = len(cohorts[i])
        key, sub = jax.random.split(key)
        chunks.append(batched_bootstrap_median(jnp.asarray(X),
                                               jnp.asarray(n_arr), sub, bs))
    stacked = chunks[0] if len(chunks) == 1 else \
        jnp.concatenate(chunks, axis=1)
    # ONE device->host transfer for every cohort's (lower, upper, p)
    lo, hi, p = np.asarray(stacked)
    for k, i in enumerate(idxs):
        out[i] = (float(lo[k]), float(hi[k]), float(p[k]))
    return out


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
