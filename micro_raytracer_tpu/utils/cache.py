"""Persistent XLA compilation cache.

The reference CLI is a short-lived process (one render per invocation,
cli.rs:155-177), so every invocation would pay the tracer's compile again.
JAX's persistent compilation cache makes repeat CLI/HTTP-server startups
skip it.

The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX
reads it itself; no other directory is set here), else in the checkout's
``.jax_cache``. Opt out with ``MRT_NO_COMPILE_CACHE=1`` (e.g. for
benchmarking cold compiles).
"""

from __future__ import annotations

import os

from .paths import COMPILE_CACHE_DIR

_done = False


def cache_dir() -> str:
    """Directory the persistent compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or COMPILE_CACHE_DIR


def enable_compile_cache() -> None:
    """Idempotently enable the persistent compilation cache."""
    global _done
    if _done or os.environ.get("MRT_NO_COMPILE_CACHE") == "1":
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
