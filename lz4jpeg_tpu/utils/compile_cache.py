"""Where JAX keeps its persistent compilation cache.

Every entry point that compiles (``bench.py``, the CLI's bench suites,
``chip_smoke.py``) calls ``enable_compile_cache`` once before its first
compilation.  The directory is ``JAX_COMPILATION_CACHE_DIR`` when the
environment sets it, and otherwise a fixed ``.jax_cache`` directory in
the checkout: the path is part of the cache key, so a directory that
moves between runs would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    and return that directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
