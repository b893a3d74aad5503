"""Device-mesh construction for multi-chip rendering.

The reference parallelizes with a CPU thread pool over a dim x dim pixel-tile
job grid merged under a mutex (reference src/sampler.rs:28-78). The
array replacement is a ``jax.sharding.Mesh`` with two logical axes:

* ``dp`` — pixel-tile data parallelism (the tile grid analogue),
* ``sp`` — sample parallelism (path-tracing samples accumulated across chips
  and ``psum``-reduced, the grad-accumulation analogue).

The mesh is topology-free: devices are laid out in ``jax.devices()`` order.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, sp: int | None = None) -> Mesh:
    """Build a (dp, sp) mesh over the first ``n_devices`` devices.

    ``sp`` defaults to 2 when the device count is even (demonstrating a
    second, non-trivial axis), else 1.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    if sp is None:
        sp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // sp
    assert dp * sp == n, f"cannot factor {n} devices into dp*sp with sp={sp}"
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))
