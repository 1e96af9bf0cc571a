"""The persistent XLA compile cache: one rule for every entry point."""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Keep compiled programs across runs; returns the cache directory.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins:
    nothing is set in code.  Otherwise the cache lives at the fixed path
    <checkout>/.jax_cache, so that a later run of the same checkout finds
    what an earlier one compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
