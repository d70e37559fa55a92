"""Device statistics kernels.

binom_cdf matches scipy.stats.binom.cdf (the reference's conflict test,
/root/reference/phaser/phaser.py:1649) via the regularized incomplete beta:
    P(X <= k) = I_{1-p}(n-k, k+1)
computed in float64-free form (float32, ~1e-6 accurate).

Where it runs: the SHARDED device pipeline (dist.mesh.sharded_phasing_step)
— psum-merged pair counts are noise-estimated, tested, and pruned on device
without leaving HBM. The host engine (engine.connections.build_connections)
always uses scipy: variant_connections.txt prints every pair's p-value at
full float64 precision, so byte-parity forces a host binom.cdf for display
regardless — and the vectorized scipy call costs microseconds at any
realistic pair count, no more than one device launch and fetch.
That trade is the documented reason there is no --device p-value path in
the engine.

Decision parity: prune_mask flags pairs whose float32 p lands within
`refine_band` of the threshold as `uncertain`; a caller wanting EXACT
scipy decisions recomputes only those (float32 p error is ~1e-6, three
orders below the default band, so the uncertain fraction is ~0).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def binom_cdf(k: jax.Array, n: jax.Array, p: jax.Array) -> jax.Array:
    k = jnp.asarray(k, jnp.float32)
    n = jnp.asarray(n, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    kk = jnp.floor(k)
    full = kk >= n
    a = jnp.maximum(n - kk, 1e-30)
    b = kk + 1.0
    x = jnp.clip(1.0 - p, 0.0, 1.0)
    val = jax.scipy.special.betainc(a, b, x)
    return jnp.where(full, 1.0, jnp.where(kk < 0, 0.0, val))


@jax.jit
def conflicting_config_p(config_a: jax.Array, config_b: jax.Array,
                         other: jax.Array, noise_e: jax.Array) -> jax.Array:
    """Vectorized test_variant_connection p-value (:1645-1652)."""
    c_supporting = jnp.maximum(config_a, config_b)
    c_total = config_a + config_b + other
    p_success = 1.0 - (6.0 * noise_e + 10.0 * noise_e ** 2)
    p = binom_cdf(c_supporting, c_total, p_success)
    p = jnp.where(c_total - c_supporting > 0, p, 1.0)
    p = jnp.where(c_supporting == 0, 0.0, p)
    return p


@functools.partial(jax.jit, static_argnames=("threshold", "refine_band"))
def prune_mask(config_a: jax.Array, config_b: jax.Array, other: jax.Array,
               noise_e: jax.Array, threshold: float,
               refine_band: float = 1e-3):
    """On-device connection pruning (phaser.py:696-707): p < threshold.

    Returns (p, prune, uncertain). `uncertain` marks pairs whose float32 p
    is within refine_band of the threshold — recompute those with scipy
    when exact host-decision parity is required; all other decisions are
    guaranteed to match (float32 cdf error ~1e-6 << band)."""
    p = conflicting_config_p(config_a, config_b, other, noise_e)
    prune = p < threshold
    uncertain = jnp.abs(p - threshold) < refine_band
    return p, prune, uncertain


@jax.jit
def noise_from_counts(counts: jax.Array) -> jax.Array:
    """Global sequencing-noise estimate from merged (M, 3) allele-class
    counts (phaser.py:610-632): variants with <5% mismatch fraction
    contribute; noise_e = mismatches / (2 * (matches + mismatches))."""
    matches = (counts[:, 0] + counts[:, 1]).astype(jnp.float32)
    mis = counts[:, 2].astype(jnp.float32)
    tot = jnp.maximum(matches + mis, 1.0)
    use = (matches > 0) & (mis / tot < 0.05)
    bm = jnp.sum(jnp.where(use, matches, 0.0))
    bmm = jnp.sum(jnp.where(use, mis, 0.0))
    return bmm / jnp.maximum((bm + bmm) * 2.0, 1.0)
