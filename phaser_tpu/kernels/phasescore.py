"""Batched 2^K haplotype-configuration scoring as one device matmul.

score(config) = v^T M v over the 2n x 2n allele adjacency (the directed
supporting-connection count of sub_block_phase,
/root/reference/phaser/phaser.py:2231-2245).  All 2^(n-1) complement classes
of a sub-block are scored as one (S x 2n) @ (2n x 2n) matmul followed by a
rowwise dot — batched over many sub-blocks with a shared padded size.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n",))
def enumerate_scores(M: jax.Array, n: int) -> jax.Array:
    """Scores for all 2^(n-1) leading-zero configs of one sub-block.

    M: (2n, 2n) float32 allele adjacency. Returns (2^(n-1),) float32.
    """
    S = 1 << max(n - 1, 0)
    cfg = jnp.arange(S, dtype=jnp.uint32)
    # bit i (MSB-first after the fixed leading 0) = allele of variant i+1
    bits = jnp.zeros((S, n), jnp.int32)
    if n > 1:
        shifts = jnp.arange(n - 2, -1, -1, dtype=jnp.uint32)
        bits = bits.at[:, 1:].set(
            ((cfg[:, None] >> shifts[None, :]) & 1).astype(jnp.int32))
    # one-hot over (n, 2) -> (S, 2n)
    pos = jnp.arange(n) * 2
    idx = pos[None, :] + bits
    V = jnp.zeros((S, 2 * n), jnp.float32)
    V = jax.vmap(lambda row, i: row.at[i].set(1.0))(V, idx)
    # HIGHEST: a float32 matmul may otherwise run in TF32 (10-bit
    # mantissa). The operands here are 0/1 and every sum is at most 2n, so
    # TF32 would happen to be exact too; the pinned precision keeps the
    # scores exact by contract, not by the operands' range.
    E = jnp.matmul(V, M, precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(E * V, axis=1)


@functools.partial(jax.jit, static_argnames=("n",))
def enumerate_scores_batched(Ms: jax.Array, n: int) -> jax.Array:
    """(B, 2n, 2n) -> (B, 2^(n-1)) batched scoring for same-size sub-blocks."""
    return jax.vmap(lambda M: enumerate_scores(M, n))(Ms)


def score_blocks_host(adjacencies: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Score a batch of sub-blocks (possibly different sizes) on device,
    bucketed by size. Returns int scores per block in input order."""
    by_n = {}
    for i, M in enumerate(adjacencies):
        n = M.shape[0] // 2
        by_n.setdefault(n, []).append(i)
    out: List[np.ndarray] = [None] * len(adjacencies)
    for n, idxs in by_n.items():
        Ms = jnp.asarray(np.stack([adjacencies[i] for i in idxs]), jnp.float32)
        scores = np.asarray(enumerate_scores_batched(Ms, n))
        for k, i in enumerate(idxs):
            out[i] = scores[k].astype(np.int64)
    return out
