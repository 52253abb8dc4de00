"""JAX runtime setup: persistent compilation cache.

A cold process compiles every program it runs; the persistent cache lets a
later process reuse them. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX
reads it itself and no other directory is set here. Otherwise the cache
lives at a fixed, git-ignored path inside the checkout: the path is part of
the cache's key, so a directory that moves never hits. Call early in every
entry point.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

log = logging.getLogger(__name__)

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_done = False


def init_compilation_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    log.debug("jax compilation cache at %s", jax.config.jax_compilation_cache_dir)
