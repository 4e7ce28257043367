"""JAX's persistent compilation cache, kept in one place.

Every entry point (tests, benchmarks, examples, tools) calls ``enable()``
before its first compile.  If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing else is set here; otherwise the cache lives in
``.jax_cache`` at the root of the checkout that holds this package, a
fixed path (the path is part of the cache key, so a moving directory would
never hit).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

__all__ = ["cache_dir", "enable"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory: the environment's, else ``<checkout>/.jax_cache``."""
    environ = os.environ if environ is None else environ
    return environ.get(_ENV) or os.path.join(_CHECKOUT, ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on for every compile; return its path."""
    import jax

    path = cache_dir()
    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program: the deep pipelines are many small compiles
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
