"""Fixed locations inside the checkout."""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the example scenes (the reference's example/*.json that this repo ships)
EXAMPLES_DIR = os.path.join(REPO_ROOT, "examples")
# XLA's persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset;
# a fixed path, because the cache key includes it
COMPILE_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
