"""Persistent XLA compilation cache setup.

Compiling the large fit graphs takes seconds to minutes; caching the
compiled executables on disk makes every later process start warm. Called
by the entry scripts; safe to call more than once.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache goes there and
nowhere else. Otherwise it lives at the fixed ``<checkout>/.jax_cache``
(the path is part of the cache key, so it must not move between runs).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""

    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        # JAX reads the variable itself; only its absence needs a default
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
