"""JAX's persistent compilation cache, set in this one place.

The engine dispatches many jitted steps; caching their executables across
runs makes a compile a one-time cost per machine instead of per process.
Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
directory is set here; otherwise the cache lives in `.jax_cache` at the root
of the checkout (listed in .gitignore). The path is fixed because it is part
of what a later run must find again.

Call enable() before the first jit dispatch.
"""
from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE)


def enable() -> None:
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    # cache everything, however fast the compile was
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
