"""One place that decides where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache(default_dir: str | None = None) -> str:
    """Return the compile-cache directory in use, setting it if needed.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing is set
    here. Otherwise the cache goes to the fixed `default_dir`, by default
    `<checkout>/.jax_cache`: the path is part of the cache key, so it must
    not move between runs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = default_dir or os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
