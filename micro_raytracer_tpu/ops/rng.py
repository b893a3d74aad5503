"""Counter-based randomness for path tracing.

The reference uses a global ``thread_rng`` (rt.rs:917-919, 996-1007 etc.);
here every draw comes from a threefry key derived from
``(base_key, sample, bounce, purpose)`` so results are reproducible and
independent of device count or tiling — the array replacement for
stateful RNG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import linalg


def make_key(seed: int):
    """Session key; ``MRT_PRNG`` picks the implementation.

    Defaults to ``rbg`` (not yet measured against threefry on a GPU);
    set ``MRT_PRNG=threefry2x32`` for host-reproducible streams.
    """
    import os

    impl = os.environ.get("MRT_PRNG", "rbg")
    return jax.random.key(seed, impl=impl)


def uniform(key, shape):
    return jax.random.uniform(key, shape, dtype=jnp.float32)


def sphere_rand(n, rough, u1, u2):
    """Jittered normal: ``normalize(n + rough * uniform_sphere)``.

    Matches ``RayTracer::rand`` (rt.rs:996-1007): ``th = acos(1 - 2 u)``,
    ``phi = 2 pi v``, direction from spherical angles — algebraically
    simplified (``cos th = 1 - 2u``, ``sin th = sqrt(1 - cos^2)``) to drop
    the arccos/cos pair, which are expensive VPU transcendentals.

    Args:
      n: ``(..., 3)`` normals.
      rough: ``(...,)`` jitter magnitude.
      u1, u2: ``(...,)`` uniforms in [0, 1).
    """
    ct = jnp.clip(1.0 - 2.0 * u1, -1.0, 1.0)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    phi = u2 * 2.0 * jnp.pi
    v = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    return linalg.safe_normalize(n + rough[..., None] * v)
