"""JAX runtime tuning for the engine's device paths.

`enable_compile_cache()` turns on JAX's persistent compilation cache so the
fused assign+compact programs are reused across CLI invocations — the
GTEx-scale use case runs thousands of samples with identical program
shapes.

Cache location: `$JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it
itself; nothing here overrides it), else the fixed directory
`<checkout>/.jax_cache`, which `.gitignore` lists.  The path must not move
between runs: it is part of what makes a later run find the cached
programs.  The engine's small sidecar files (learned hit capacities,
warm-cache markers) live in the same directory (`cache_dir()`).
"""

from __future__ import annotations

import os

# <checkout>/phaser_tpu/utils/jaxtune.py -> <checkout>/.jax_cache
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_done = False


def cache_dir() -> str:
    """Directory of the persistent compile cache and its sidecars."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # 0.0: also persist the many small programs (collective allgathers,
    # shape-bucketed helpers) — each costs 50-200 ms to compile and the
    # multi-process engine pays that per process otherwise
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
