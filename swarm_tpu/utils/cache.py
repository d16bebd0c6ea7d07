"""Persistent XLA compilation cache.

A cold run of the fused rollout compiles for tens of seconds; the cache lets
later runs of the same program start in seconds.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it, and no
    other directory is set here. Otherwise the cache is the fixed
    `<checkout>/.jax_cache` (git-ignored)."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache_dir = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
