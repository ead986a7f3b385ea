"""Persistent-compile-cache setup (the kalloc zero-setup-cost analogue).

The reference's arena exists so a million alignment calls pay no per-call
allocation cost (kalloc.c:41-62).  Here the per-process setup cost is XLA
compilation, one program per bucket shape; JAX's persistent compilation
cache lets a later process load them instead.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that directory and
this module sets nothing.  Otherwise the cache lives at one fixed path
inside the checkout, :data:`CACHE_DIR` (listed in ``.gitignore``).  Runs
forced onto the CPU keep no cache: XLA:CPU entries are specific to the
host's instruction set.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def _platforms() -> str:
    import jax

    return str(jax.config.jax_platforms or "").strip().lower()


def ensure_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or _platforms() == "cpu":
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


__all__ = ["CACHE_DIR", "ensure_compile_cache"]
