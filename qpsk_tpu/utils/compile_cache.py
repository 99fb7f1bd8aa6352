"""The one place the persistent XLA compile cache is configured.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``, ``tools/*.py``)
call ``enable_compile_cache()`` once, before their first compile.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the cache and
nothing else is set; otherwise the cache is ``<checkout>/.jax_cache``
(listed in ``.gitignore``) — a fixed path, since the path is part of the
cache key.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """The compile cache directory this process uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(CHECKOUT / ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()`` and cache
    every compile that takes a second or more.  Returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
