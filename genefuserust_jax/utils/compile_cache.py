"""Where JAX keeps its persistent compile cache.

The cache key includes the directory, so the directory has to stay put
between runs for a cache entry to be found again.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Use `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it itself,
    so nothing is set here); otherwise point the cache at the fixed
    `<checkout>/.jax_cache`. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
