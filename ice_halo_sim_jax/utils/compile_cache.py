"""One place that decides where JAX keeps its persistent compilation cache.

The path is part of the cache's key, so a cache that moves never hits:
every entry point (CLI, server, benchmark, chip smoke check, tests) calls
``enable_compile_cache()`` and gets the same directory.
"""

from __future__ import annotations

import os

# The checkout root: the directory that holds the package.
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has already read it into
    ``jax.config.jax_compilation_cache_dir`` and it is used as it is.
    Otherwise the cache lives in ``.jax_cache/`` at the checkout root.
    """
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
