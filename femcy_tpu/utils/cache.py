"""Where the entry points keep JAX's persistent compilation cache.

The library itself sets no cache.  The entry points (the CLI, bench.py,
chip_smoke.py, __graft_entry__.py) call :func:`configure_compile_cache`:
when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and
nothing else is configured; otherwise the cache goes to the fixed path
``<repo>/.jax_cache`` (listed in .gitignore), so every run from the same
checkout finds the programs compiled by the last one.  JAX's own
minimum-compile-time and minimum-entry-size floors are left at their
defaults.
"""

from __future__ import annotations

import os
import pathlib
from typing import Mapping, Optional

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory the entry points use under ``environ``."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE)


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
