"""Primary-ray generation: pinhole camera with depth of field.

Vectorized re-derivation of ``RayTracer::cast`` + ``RayTracer::iter``
(reference src/rt.rs:900-954): pixel -> uv with aspect and SSAA, fov ->
direction, focus-point construction, per-sample aperture jitter on the x/z
axes, and the ``rot_y(cam.dir) @ lookat(cam.dir)`` orientation. The aperture
jitter uses two threefry uniforms per (pixel, sample) instead of a global RNG.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import linalg
from ..ops.linalg import EPS
from .compiler import CameraArrays


def gen_rays(cam: CameraArrays, render_wh, coords, u_aprt):
    """Generate primary rays for integer pixel coordinates.

    Args:
      cam: camera arrays.
      render_wh: static ``(nw, nh)`` supersampled resolution.
      coords: ``(R, 2)`` float pixel coords (x, y) at render resolution.
      u_aprt: ``(R, 2)`` uniforms for the aperture jitter.
    Returns:
      ``(orig, dirs)`` each ``(R, 3)``; origins already E-offset
      (``Ray::cast_default``, rt.rs:555-557).
    """
    w = float(render_wh[0])
    h = float(render_wh[1])
    aspect = w / h

    # pixel -> uv (rt.rs:938-945)
    uvx = aspect * (coords[:, 0] - 0.5 * w) / w
    uvy = (coords[:, 1] - 0.5 * h) / h

    # fov -> direction (rt.rs:902-908)
    tan_fov = jnp.tan(jnp.deg2rad(0.5 * cam.fov))
    d = linalg.normalize(jnp.stack(
        [uvx, jnp.broadcast_to(1.0 / (2.0 * tan_fov), uvx.shape), -uvy], axis=-1))

    # depth of field (rt.rs:910-922): focus point from the E-offset ray,
    # aperture jitter on world x/z only.
    p = (cam.pos[None] + d * EPS) + d * cam.foc
    jitter = (u_aprt - 0.5) * cam.aprt
    pos = cam.pos[None] + jnp.stack(
        [jitter[:, 0], jnp.zeros_like(jitter[:, 0]), jitter[:, 1]], axis=-1)
    new_dir = linalg.normalize(p - pos)

    # orientation (rt.rs:924-930); explicit component math keeps full f32
    # precision (a default-precision einsum may round its inputs)
    M = linalg.matmul3(linalg.rotate_y_mat(cam.dir), linalg.lookat_mat(cam.dir))
    dirs = linalg.matvec(M[None], new_dir)

    orig = pos + dirs * EPS  # Ray::cast_default offset
    return orig, dirs
