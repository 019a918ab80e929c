"""Where JAX keeps its persistent compilation cache.

The one place that configures it; the CLI, ``bench.py`` and
``chip_smoke.py`` call :func:`configure_compile_cache` before their
first compile. ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads
it itself and nothing here overrides it. Otherwise the cache lives at
the fixed path ``<checkout>/.jax_cache`` (gitignored): the path is part
of the cache key, so a directory that moved between runs would never
hit.
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_CACHE_DIR", "configure_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one directory.

    Returns the directory in use.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
