"""One place that turns on JAX's persistent compilation cache.

Every entry point (``main.py``, the CLI, ``bench.py``, ``chip_smoke.py``,
the tools and the tests) calls :func:`enable_compile_cache` before its
first compile.  ``JAX_COMPILATION_CACHE_DIR``, when set, names the
directory and nothing else is set in code; otherwise the cache lives at
the fixed ``.jax_cache/`` of the checkout (git-ignored), so repeated runs
of the same checkout hit it.  A moving (temporary, per-process) path
would never hit: the path is part of what makes the cache reusable.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory :func:`enable_compile_cache` uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Cache every compiled program; returns the cache directory."""
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return compile_cache_dir()
