"""Batched 3-vector / rotation math for the path tracer.

Re-derives the math layer of the reference renderer (reference ``src/lin.rs``)
as array-programming primitives over ``(..., 3)`` stacks instead of scalar
``Vec3f`` objects.  Every function broadcasts over arbitrary leading axes so the
same code serves one ray or a million.

Coordinate convention (lin.rs:40-50): +y forward, +x right, +z up.
Direction 4-vectors are stored ``[w, x, y, z]`` (lin.rs:10-25, 428-443) where
``w`` is an extra roll parameter consumed by :func:`rotate_y_mat`
(lin.rs:175-183) and ``proj() = (x, y, z)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-4  # the reference's global intersection epsilon (rt.rs:7)


def dot(a, b):
    """Dot product over the trailing axis. (lin.rs:259-264)"""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Cross product over the trailing axis. (lin.rs:52-58)"""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def mag(a):
    """Euclidean norm of the trailing axis. (lin.rs:60-62)"""
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a):
    """a / |a|, matching the reference's ``norm`` (lin.rs:64-66).

    Zero vectors produce non-finite output exactly like the Rust code; callers
    that need safety mask beforehand.
    """
    return a * (1.0 / mag(a))[..., None]


def safe_normalize(a, eps=1e-20):
    """Gradient-safe normalize: zero vectors map to zero, not NaN.

    The plain :func:`normalize` reproduces Rust float semantics (0 -> NaN),
    but under AD a NaN/inf primal on a *masked* lane still poisons the
    backward pass (0 cotangent x inf = NaN). Use this wherever the result
    is masked or only geometrically meaningful for non-degenerate vectors.
    """
    m2 = jnp.sum(a * a, axis=-1)
    inv = jax.lax.rsqrt(jnp.maximum(m2, eps))
    return a * inv[..., None]


def reflect(v, n):
    """Mirror ``v`` about normal ``n``: ``v - 2 (v.n) n``. (lin.rs:68-70)"""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(v, eta, n):
    """Snell refraction (lin.rs:96-105).

    Returns ``(dir, ok)`` where ``ok`` is False on total internal reflection
    (the reference returns ``None``). ``dir`` is unnormalized, like the
    reference (normalization happens at the call site, rt.rs:586).
    """
    cos = -dot(n, v)
    k = 1.0 - eta * eta * (1.0 - cos * cos)
    ok = k >= 0.0
    # TIR lanes get k:=1 (not max(k, 0)): sqrt(0) has an infinite gradient
    # that would poison masked lanes' cotangents under AD.
    k_safe = jnp.where(ok, jnp.maximum(k, 1e-12), 1.0)
    out = v * eta[..., None] + n * (cos * eta + jnp.sqrt(k_safe))[..., None]
    return out, ok


def rotate_y_mat(dir4):
    """Roll rotation about the forward axis from a ``[w,x,y,z]`` direction.

    Mirrors ``Mat3f::rotate_y`` (lin.rs:175-183): treats ``dir.w`` as the sine
    of the roll angle, ``cw = sqrt(1 - w^2)``.

    Args:
      dir4: ``(..., 4)`` direction.
    Returns:
      ``(..., 3, 3)`` rotation matrices.
    """
    w = dir4[..., 0]
    cw = jnp.sqrt(1.0 - w * w)
    zero = jnp.zeros_like(w)
    one = jnp.ones_like(w)
    rows = [
        jnp.stack([cw, zero, w], axis=-1),
        jnp.stack([zero, one, zero], axis=-1),
        jnp.stack([-w, zero, cw], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def lookat_mat(dir4, up=None):
    """Orientation matrix from a ``[w,x,y,z]`` direction (lin.rs:197-208).

    Reproduces ``Mat4f::lookat`` including its sign quirks (negated y column)
    and the fact that ``Mat4f * Vec3f`` reads rows 0-2/4-6/8-10 of the 4x4
    (lin.rs:356-365), i.e. effectively a 3x3.

    Args:
      dir4: ``(..., 4)`` camera/instance direction.
      up: ``(3,)`` up vector, defaults to +z.
    Returns:
      ``(..., 3, 3)``.
    """
    if up is None:
        up = jnp.array([0.0, 0.0, 1.0], dtype=dir4.dtype)
    fwd = normalize(dir4[..., 1:4])
    right = normalize(cross(fwd, jnp.broadcast_to(up, fwd.shape)))
    n_up = cross(right, fwd)
    rows = [
        jnp.stack([right[..., 0], -right[..., 1], right[..., 2]], axis=-1),
        jnp.stack([-fwd[..., 0], fwd[..., 1], -fwd[..., 2]], axis=-1),
        jnp.stack([n_up[..., 0], -n_up[..., 1], n_up[..., 2]], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def matvec(m, v):
    """``(..., 3, 3) @ (..., 3)`` with broadcasting.

    Expanded to explicit component arithmetic instead of einsum: a 3-wide
    contraction lowered as a matmul wastes most of the matmul unit and
    may round its inputs; 9 fused multiply-adds stay elementwise in f32
    and fuse with their neighbours.
    """
    return jnp.stack(
        [m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
         + m[..., i, 2] * v[..., 2] for i in range(3)],
        axis=-1)


def matmul3(a, b):
    """``(..., 3, 3) @ (..., 3, 3)`` with broadcasting, on the VPU."""
    rows = [[sum(a[..., i, k] * b[..., k, j] for k in range(3))
             for j in range(3)] for i in range(3)]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def instance_mat(dir4):
    """Combined object-space transform for an instance direction.

    The reference maps rays into object space (and normals back to world
    space) with ``rot_y(-dir) * (lookat(-dir) * v)`` (rt.rs:726-733, 776-793).
    Both directions use the *same* matrix — a quirk preserved here.

    Args:
      dir4: ``(..., 4)`` instance direction.
    Returns:
      ``(..., 3, 3)`` matrix ``M = rot_y(-dir) @ lookat(-dir)``.
    """
    neg = -dir4
    return matmul3(rotate_y_mat(neg), lookat_mat(neg))
