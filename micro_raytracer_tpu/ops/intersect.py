"""Batched ray-primitive intersection, normals, UVs, and material sampling.

Array replacement for the reference's trait-dispatch intersection core
(reference ``src/rt.rs:299-548, 706-898``): every ray in a batch is
tested against every primitive row of the compiled scene as one dense
``(R, P)`` computation, per kind-sorted segment. The closest hit is a masked
argmin; mesh entry/exit hits fall out of a ``group_id`` max-reduction exactly
matching rt.rs:740-772. There is no BVH: every ray sweeps every row, so work
grows with R*P (an acceleration structure is an open roadmap item).

Semantics preserved per primitive (validity conditions identical to the
reference):
  sphere   quadratic, ``t0 >= 0`` required (inside counts as miss) rt.rs:335-358
  plane    double-sided, ``t > 0``                                  rt.rs:400-412
  box      slab test w/ 1/0 -> 1e4 workaround, ``t0<=t1 && t1>=0``  rt.rs:299-332
           (entry t may be negative when the origin is inside)
  triangle Moller-Trumbore, backface-inclusive, ``|det|>=E, t>=0``  rt.rs:361-398

Deviation: non-finite ``t`` values (e.g. a plane seen edge-on producing
``inf``) are treated as misses instead of propagating like the Rust float
semantics would; this only affects degenerate rays.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from ..models import schema
from ..models.compiler import SceneArrays
from . import linalg
from .linalg import EPS

_BIG = 3.0e38


def build_frames(scene: SceneArrays):
    """Per-primitive instance matrices ``M = rot_y(-dir) @ lookat(-dir)``.

    The same matrix maps rays world->object and normals object->world
    (rt.rs:726-733, 776-793 apply it in both directions). Differentiable
    w.r.t. ``scene.inst_dir``.
    """
    return linalg.instance_mat(scene.inst_dir)  # (P,3,3)


def _use_tri_mxu(count: int) -> bool:
    """Whether the triangle segment uses the matmul (Woop-transform) sweep.

    Default: on for triangle-heavy scenes (64 rows or more), where the
    Moller-Trumbore sweep's (R, Pt, 3) intermediates are large. Not yet
    measured against Moller-Trumbore on a GPU. ``MRT_TRI_MXU=0/1`` forces
    either path (tests use this to compare them).
    """
    import os

    env = os.environ.get("MRT_TRI_MXU", "")
    if env in ("0", "1"):
        return env == "1"
    return count >= 64


def triangle_pack(scene: SceneArrays, frames):
    """Per-triangle unit-space ("Woop") transforms for the matmul sweep.

    For triangle (v0, v1, v2) with edges e0, e1 and raw normal n = e0 x e1,
    the matrix ``W = [e0 e1 n]^-1`` maps any point q to barycentric
    coordinates: ``W @ (q - v0') = (u, v, w)``. Rows of W have the closed
    form ``[(e1 x n), (n x e0), n] / (n . n)``. Composing with the instance
    transform (rays are tested in object space, rt.rs:729-732) gives ray-
    independent per-triangle constants

        G = W @ M,   h = -G @ ipos - W @ v0,   o' = G o + h,   d' = G d

    so the whole (R, Pt) triangle sweep becomes two ``(R,3) @ (3,3Pt)``
    matmuls plus elementwise tests — identical t/u/v to
    Moller-Trumbore (rt.rs:361-398) in exact arithmetic. The |det| >= E
    validity window maps to ``|d'_z| >= E / (n . n)`` since
    ``det = -d_obj . n = -d'_z (n . n)``.

    Returns (G, h, thr, nondegenerate) over the triangle segment;
    differentiable w.r.t. vertices and instance parameters.
    """
    s = scene.seg(schema.KIND_TRIANGLE)
    a, b, c = scene.prim_a[s], scene.prim_b[s], scene.prim_c[s]
    pos = scene.inst_pos[s]
    M = frames[s]                                   # (Pt,3,3)
    e0, e1 = b - a, c - a
    n = linalg.cross(e0, e1)                        # (Pt,3)
    nn = linalg.dot(n, n)
    ok = nn > 0.0                                   # degenerate/padded rows
    nn_s = jnp.where(ok, nn, 1.0)[..., None]
    W = jnp.stack([linalg.cross(e1, n) / nn_s,
                   linalg.cross(n, e0) / nn_s,
                   n / nn_s], axis=-2)              # (Pt,3,3)
    G = linalg.matmul3(W, M)
    h = -linalg.matvec(G, pos) - linalg.matvec(W, a)
    thr = EPS / nn_s[..., 0]
    return G, h, thr, ok


def _tri_sweep_mxu(pack, valid, orig, dirs):
    """(R, Pt) triangle hit sweep via the precomputed Woop transforms."""
    G, h, thr, okg = pack
    Pt = G.shape[0]
    Gf = G.reshape(Pt * 3, 3)
    # (R,3) @ (3, 3Pt): geometry matmuls MUST run at highest precision —
    # a default-precision matmul may round its inputs (TF32 tensor cores;
    # see fetch_attrs).
    dn = (((1,), (1,)), ((), ()))
    O = jax.lax.dot_general(orig, Gf, dn, precision=jax.lax.Precision.HIGHEST)
    D = jax.lax.dot_general(dirs, Gf, dn, precision=jax.lax.Precision.HIGHEST)
    O = O.reshape(-1, Pt, 3) + h[None]
    D = D.reshape(-1, Pt, 3)
    oz, dz = O[..., 2], D[..., 2]
    ok = jnp.abs(dz) >= thr[None]                   # |det| >= E (rt.rs:371-373)
    dz_s = jnp.where(ok, dz, 1.0)
    t = -oz / dz_s
    u = O[..., 0] + t * D[..., 0]
    v = O[..., 1] + t * D[..., 1]
    ok &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    ok &= okg[None] & valid[None]
    return t, ok


def _kind_array(scene: SceneArrays):
    """Static (P,) int32 of kind codes derived from segment counts."""
    parts = [jnp.full((c,), k, dtype=jnp.int32)
             for k, c in enumerate(scene.kind_counts) if c]
    if not parts:
        return jnp.zeros((0,), jnp.int32)
    return jnp.concatenate(parts)


def intersect_all(scene: SceneArrays, frames, orig, dirs, tri_pack=None):
    """Intersect a ray batch against every primitive row.

    Args:
      scene: compiled scene.
      frames: ``(P,3,3)`` from :func:`build_frames`.
      orig: ``(R,3)`` ray origins (already E-offset by the caster).
      dirs: ``(R,3)`` ray directions.
      tri_pack: optional precomputed :func:`triangle_pack` (hoisted out of
        the bounce scan by the tracer); computed on the fly when the matmul
        triangle sweep is active and none is given.
    Returns:
      ``(t_entry, t_exit, valid)`` each ``(R, P)``.
    """
    R = orig.shape[0]
    t0_parts, t1_parts, ok_parts = [], [], []
    for kind, count in enumerate(scene.kind_counts):
        if count == 0:
            continue
        if kind == schema.KIND_TRIANGLE and _use_tri_mxu(count):
            if tri_pack is None:
                tri_pack = triangle_pack(scene, frames)
            t0, ok = _tri_sweep_mxu(
                tri_pack, scene.prim_valid[scene.seg(kind)], orig, dirs)
            ok = ok & jnp.isfinite(t0)
            t0_parts.append(t0)
            t1_parts.append(t0)
            ok_parts.append(ok)
            continue
        s = scene.seg(kind)
        pos = scene.inst_pos[s][None]
        # World -> object space per (ray, prim) pair (rt.rs:729-732),
        # computed per kind segment so each branch's (R, Pk, 3)
        # intermediates fuse into that branch instead of materializing one
        # full (R, P, 3) tensor that every branch re-reads from HBM.
        # matvec broadcasts (Pk,3,3) against (R,Pk,3)/(R,1,3) elementwise.
        fr_s = frames[s][None]
        o_rel = orig[:, None, :] - pos                              # (R,Pk,3)
        o_s = linalg.matvec(fr_s, o_rel) + pos
        d_s = linalg.matvec(fr_s, dirs[:, None, :])                  # (R,Pk,3)
        # All divisions/sqrts below are guarded so invalid lanes never hold
        # inf/NaN primals: under AD a zero cotangent times an infinite local
        # derivative still yields NaN, poisoning whole gradient batches.
        if kind == schema.KIND_SPHERE:
            o = o_s - pos
            a = linalg.dot(d_s, d_s)
            od = linalg.dot(o, d_s)
            b = 2.0 * od
            # disc = b^2 - 4ac, evaluated as 4a (r^2 - |f|^2) with f the
            # centre's offset from the ray line: equal in exact arithmetic,
            # but b^2 and 4ac cancel in f32 for small, distant spheres
            f = o - (od / jnp.where(a == 0.0, 1.0, a))[..., None] * d_s
            disc = 4.0 * a * (scene.prim_r[s][None] ** 2 - linalg.dot(f, f))
            sq = jnp.sqrt(jnp.where(disc >= 0.0, jnp.maximum(disc, 1e-12), 1.0))
            a2 = jnp.where(a == 0.0, 1.0, 2.0 * a)
            t0 = (-b - sq) / a2
            t1 = (-b + sq) / a2
            ok = (disc >= 0.0) & (t0 >= 0.0)
        elif kind == schema.KIND_PLANE:
            # safe: zero-padded rows otherwise put NaN primals in the whole
            # column and poison gradients through the masked reductions
            n = linalg.safe_normalize(scene.prim_a[s])[None]        # (1,Pk,3)
            d = -linalg.dot(n, pos)
            dn = linalg.dot(d_s, n)
            t0 = -(linalg.dot(o_s, n) + d) / jnp.where(dn == 0.0, 1.0, dn)
            t1 = t0
            ok = (t0 > 0.0) & (dn != 0.0)
        elif kind == schema.KIND_BOX:
            # 1/0 -> 1/E (sign dropped), matching rt.rs:306-316, without an
            # intermediate inf
            m = 1.0 / jnp.where(d_s == 0.0, 1.0, d_s)
            m = jnp.where(d_s == 0.0, 1.0 / EPS, m)
            n = (o_s - pos) * m
            k = (0.5 * scene.prim_a[s][None]) * jnp.abs(m)
            t0 = jnp.max(-n - k, axis=-1)
            t1 = jnp.min(-n + k, axis=-1)
            ok = ~((t0 > t1) | (t1 < 0.0))
        else:  # KIND_TRIANGLE
            v0 = scene.prim_a[s][None]
            e0 = (scene.prim_b[s] - scene.prim_a[s])[None]
            e1 = (scene.prim_c[s] - scene.prim_a[s])[None]
            pv = linalg.cross(d_s, jnp.broadcast_to(e1, d_s.shape))
            det = linalg.dot(e0, pv)
            ok = jnp.abs(det) >= EPS                                 # rt.rs:371-373
            inv = 1.0 / jnp.where(ok, det, 1.0)
            tv = o_s - (v0 + pos)
            u = linalg.dot(tv, pv) * inv
            ok &= (u >= 0.0) & (u <= 1.0)
            qv = linalg.cross(tv, jnp.broadcast_to(e0, tv.shape))
            v = linalg.dot(d_s, qv) * inv
            ok &= (v >= 0.0) & (u + v <= 1.0)
            t0 = linalg.dot(jnp.broadcast_to(e1, qv.shape), qv) * inv
            ok &= t0 >= 0.0
            t1 = t0
        ok = ok & scene.prim_valid[s][None] & jnp.isfinite(t0) & jnp.isfinite(t1)
        t0_parts.append(t0)
        t1_parts.append(t1)
        ok_parts.append(ok)

    if not t0_parts:
        z = jnp.zeros((R, 0), orig.dtype)
        return z, z, jnp.zeros((R, 0), bool)
    t_entry = jnp.concatenate(t0_parts, axis=1)
    t_exit = jnp.concatenate(t1_parts, axis=1)
    valid = jnp.concatenate(ok_parts, axis=1)
    return t_entry, t_exit, valid


def any_hit(scene: SceneArrays, frames, orig, dirs, tri_pack=None):
    """Occlusion query: does the ray hit anything at all? (rt.rs:1036-1038)"""
    _, _, valid = intersect_all(scene, frames, orig, dirs, tri_pack=tri_pack)
    return jnp.any(valid, axis=-1)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["hit", "t_entry", "t_exit", "idx_entry", "idx_exit"],
    meta_fields=[],
)
@dataclass
class HitInfo:
    hit: Any        # (R,) bool
    t_entry: Any    # (R,)
    t_exit: Any     # (R,)
    idx_entry: Any  # (R,) int32 winning prim row
    idx_exit: Any   # (R,) int32 farthest-exit prim row within the winning group


# ---------------------------------------------------------------------------
# Attribute fetching: instead of ~30 per-ray gathers of the winning
# primitive's data (frames, geometry, material), all per-primitive attributes
# are packed once per trace into a dense (P, K) matrix and the winner's row
# is fetched once — as a one-hot (R, P) @ (P, K) matmul for small tables, a
# row gather for large ones. The one-hot is constant w.r.t. gradients; the
# attribute values carry them, so differentiability is unchanged.


class AttrView:
    """Column view over a fetched ``(..., K)`` attribute block."""

    # column layout (K = 34 + 6 map ids when textured)
    _F = 0          # frames, 9
    _IPOS = 9       # inst_pos, 3
    _A = 12         # prim_a, 3
    _B = 15         # prim_b, 3
    _C = 18         # prim_c, 3
    _R = 21         # radius, 1
    _KIND = 22      # kind one-hot, 4
    _ALBEDO = 26    # 3
    _ROUGH = 29
    _METAL = 30
    _GLASS = 31
    _OPACITY = 32
    _EMIT = 33
    K = 34
    _MAPS = 34      # 6 texture ids as f32 (only when has_maps)
    K_MAPS = 40

    def __init__(self, fetched):
        self.v = fetched

    @property
    def frames(self):
        return self.v[..., self._F:self._F + 9].reshape(self.v.shape[:-1] + (3, 3))

    @property
    def inst_pos(self):
        return self.v[..., self._IPOS:self._IPOS + 3]

    @property
    def prim_a(self):
        return self.v[..., self._A:self._A + 3]

    @property
    def prim_b(self):
        return self.v[..., self._B:self._B + 3]

    @property
    def prim_c(self):
        return self.v[..., self._C:self._C + 3]

    @property
    def radius(self):
        return self.v[..., self._R]

    def kind_is(self, kind: int):
        return self.v[..., self._KIND + kind] > 0.5

    @property
    def albedo(self):
        return self.v[..., self._ALBEDO:self._ALBEDO + 3]

    @property
    def rough(self):
        return self.v[..., self._ROUGH]

    @property
    def metal(self):
        return self.v[..., self._METAL]

    @property
    def glass(self):
        return self.v[..., self._GLASS]

    @property
    def opacity(self):
        return self.v[..., self._OPACITY]

    @property
    def emit(self):
        return self.v[..., self._EMIT]

    def map_id(self, slot: int):
        return self.v[..., self._MAPS + slot].astype(jnp.int32)


def prim_attributes(scene: SceneArrays, frames):
    """Pack all per-primitive attributes into one dense ``(P, K)`` matrix.

    Material scalars are expanded per primitive via tiny (P,)-sized gathers
    of the material tables — still differentiable leaves; gradients flow
    back through the gather to the shared material rows.
    """
    P = scene.n_prims
    kind_arr = _kind_array(scene)
    kind_oh = jax.nn.one_hot(kind_arr, 4, dtype=frames.dtype)
    m = scene.mat_id
    cols = [
        frames.reshape(P, 9),
        scene.inst_pos,
        scene.prim_a, scene.prim_b, scene.prim_c,
        scene.prim_r[:, None],
        kind_oh,
        scene.mat_albedo[m],
        scene.mat_rough[m][:, None],
        scene.mat_metal[m][:, None],
        scene.mat_glass[m][:, None],
        scene.mat_opacity[m][:, None],
        scene.mat_emit[m][:, None],
    ]
    if scene.has_maps:
        cols.append(scene.mat_maps[m].astype(frames.dtype))  # exact: small ints
    return jnp.concatenate(cols, axis=1)


_FETCH_GATHER_MIN = 256


def fetch_attrs(attrs, idx, n_prims: int) -> AttrView:
    """Fetch rows of ``attrs`` at ``idx``.

    Tables under 256 rows use a one-hot matmul; large tables use one
    K-wide row gather — the one-hot materializes an (R, P) f32 matrix
    whose traffic grows with scene size while the gather's stays R*K
    (``MRT_FETCH_GATHER`` forces either path). Which is faster on a GPU
    has not been measured.

    Matmul precision MUST be highest: a default-precision matmul may
    round its inputs (TF32 tensor cores keep a 10-bit mantissa), which
    destroys the fetched geometry (the box-normal face test compares
    against an EPS=1e-4 window that such rounding cannot represent).
    """
    import os

    env = os.environ.get("MRT_FETCH_GATHER", "")
    gather = n_prims >= _FETCH_GATHER_MIN if env == "" else env == "1"
    if gather:
        return AttrView(jnp.take(attrs, idx, axis=0))
    onehot = jax.nn.one_hot(idx, n_prims, dtype=attrs.dtype)      # (R, P)
    fetched = jax.lax.dot(jax.lax.stop_gradient(onehot), attrs,
                          precision=jax.lax.Precision.HIGHEST)
    return AttrView(fetched)


def closest_hit(scene: SceneArrays, frames, orig, dirs,
                need_exit: bool = True, tri_pack=None) -> HitInfo:
    """Masked argmin over entry t + group-max for the exit hit.

    The winner is the (object, instance) pair with the smallest entry ``t``
    (rt.rs:867-872); its exit hit is the farthest ``t`` among valid hits in
    the same group (one prim for sphere/plane/box/triangle; all triangles of
    the mesh instance otherwise — rt.rs:758-771).
    """
    t_entry, t_exit, valid = intersect_all(scene, frames, orig, dirs,
                                           tri_pack=tri_pack)
    hit = jnp.any(valid, axis=-1)
    masked_entry = jnp.where(valid, t_entry, _BIG)
    win = jnp.argmin(masked_entry, axis=-1).astype(jnp.int32)
    # The winning value IS the min — a reduction, not a take_along_axis
    # gather (profiling showed the two row-gathers here dominating the step).
    te = jnp.min(masked_entry, axis=-1)

    if not need_exit:
        # Only refraction consumes the exit hit (rt.rs:1054-1058); opaque
        # scenes skip the whole group-max sweep.
        return HitInfo(hit=hit, t_entry=te, t_exit=te,
                       idx_entry=win, idx_exit=win)

    win_group = scene.group_id[win]                                  # (R,)
    same = valid & (scene.group_id[None, :] == win_group[:, None])
    masked_exit = jnp.where(same, t_exit, -_BIG)
    idx_exit = jnp.argmax(masked_exit, axis=-1).astype(jnp.int32)
    tx = jnp.max(masked_exit, axis=-1)
    return HitInfo(hit=hit, t_entry=te, t_exit=tx, idx_entry=win, idx_exit=idx_exit)


def normal_from_attrs(at: AttrView, point):
    """World-space normal from fetched winner attributes (rt.rs:776-793).

    Same math as :func:`normal_at` — object-space normal mapped back through
    the instance matrix — but over pre-fetched ``(R, K)`` attribute rows
    instead of per-ray gathers.
    """
    M = at.frames
    ipos = at.inst_pos
    hp = ipos + linalg.matvec(M, point - ipos)

    n_sph = hp - ipos
    n_pln = at.prim_a
    sizes = jnp.where(at.prim_a == 0, 1.0, at.prim_a)
    p = (hp - ipos) * (2.0 / sizes)
    def _in(v, target):
        return jnp.abs(v - target) < EPS
    ex = jnp.array([1.0, 0.0, 0.0], point.dtype)
    ey = jnp.array([0.0, 1.0, 0.0], point.dtype)
    ez = jnp.array([0.0, 0.0, 1.0], point.dtype)
    zero3 = jnp.zeros_like(point)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    base = jnp.where(_in(px, 1.0)[..., None], ex,
           jnp.where(_in(px, -1.0)[..., None], -ex,
           jnp.where(_in(py, 1.0)[..., None], ey,
           jnp.where(_in(py, -1.0)[..., None], -ey, zero3))))
    # the z test is NOT chained to the x/y chain (missing `else`, rt.rs:435)
    n_box = jnp.where(_in(pz, 1.0)[..., None], ez,
            jnp.where(_in(pz, -1.0)[..., None], -ez, base))
    n_tri = linalg.cross(at.prim_b - at.prim_a, at.prim_c - at.prim_a)

    n_obj = jnp.where(at.kind_is(schema.KIND_SPHERE)[..., None], n_sph,
            jnp.where(at.kind_is(schema.KIND_PLANE)[..., None], n_pln,
            jnp.where(at.kind_is(schema.KIND_BOX)[..., None], n_box, n_tri)))
    return linalg.safe_normalize(linalg.matvec(M, n_obj))


def uv_from_attrs(at: AttrView, point):
    """Texture coordinates from fetched attributes (rt.rs:468-548)."""
    M = at.frames
    ipos = at.inst_pos
    hp = ipos + linalg.matvec(M, point - ipos)

    v = linalg.normalize(hp - ipos)
    uv_sph = jnp.stack([
        0.5 + 0.5 * jnp.arctan2(v[..., 0], -v[..., 1]) / jnp.pi,
        0.5 - 0.5 * v[..., 2],
    ], axis=-1)
    fx = (hp[..., 0] + 0.5) - jnp.trunc(hp[..., 0] + 0.5)
    fy = (hp[..., 1] + 0.5) - jnp.trunc(hp[..., 1] + 0.5)
    uv_pln = jnp.stack([jnp.where(fx < 0, 1.0 + fx, fx),
                        jnp.where(fy < 0, 1.0 + fy, fy)], axis=-1)
    sizes = jnp.where(at.prim_a == 0, 1.0, at.prim_a)
    p = (hp - ipos) * (2.0 / sizes)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    def _in(vv, target):
        return jnp.abs(vv - target) < EPS
    u_right = jnp.stack([(0.5 + 0.5 * py) / 4.0 + 2.0 / 4.0,
                         (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_left = jnp.stack([(0.5 - 0.5 * py) / 4.0,
                        (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_fwd = jnp.stack([(0.5 - 0.5 * px) / 4.0 + 3.0 / 4.0,
                       (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_back = jnp.stack([(0.5 + 0.5 * px) / 4.0 + 1.0 / 4.0,
                        (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_top = jnp.stack([(0.5 + 0.5 * px) / 4.0 + 1.0 / 4.0,
                       (0.5 - 0.5 * py) / 3.0], axis=-1)
    u_bot = jnp.stack([(0.5 + 0.5 * px) / 4.0 + 1.0 / 4.0,
                       (0.5 + 0.5 * py) / 3.0 + 2.0 / 3.0], axis=-1)
    uv_box = jnp.where(_in(px, 1.0)[..., None], u_right,
             jnp.where(_in(px, -1.0)[..., None], u_left,
             jnp.where(_in(py, 1.0)[..., None], u_fwd,
             jnp.where(_in(py, -1.0)[..., None], u_back,
             jnp.where(_in(pz, 1.0)[..., None], u_top,
             jnp.where(_in(pz, -1.0)[..., None], u_bot,
                       jnp.zeros_like(u_top)))))))
    return jnp.where(at.kind_is(schema.KIND_SPHERE)[..., None], uv_sph,
           jnp.where(at.kind_is(schema.KIND_PLANE)[..., None], uv_pln,
           jnp.where(at.kind_is(schema.KIND_BOX)[..., None], uv_box,
                     jnp.zeros_like(uv_sph))))


def material_from_attrs(scene: SceneArrays, at: AttrView, point):
    """Material dict from fetched attributes (rt.rs:811-863)."""
    out = {
        "color": at.albedo,
        "rough": at.rough,
        "metal": at.metal,
        "glass": at.glass,
        "opacity": at.opacity,
        "emit": at.emit,
        "metal_scalar": at.metal,
    }
    if not scene.has_maps:
        return out
    uv = uv_from_attrs(at, point)
    if scene.map_slots[0]:
        tex_rgb = sample_texture(scene, at.map_id(0), uv)
        out["color"] = jnp.where((at.map_id(0) >= 0)[..., None],
                                 out["color"] * tex_rgb, out["color"])
    for slot, key in ((1, "rough"), (2, "metal"), (3, "glass"),
                      (4, "opacity"), (5, "emit")):
        if not scene.map_slots[slot]:
            continue  # statically absent: no gather compiled
        val = sample_texture(scene, at.map_id(slot), uv)[..., 0]
        out[key] = jnp.where(at.map_id(slot) >= 0, val, out[key])
    return out


def normal_at(scene: SceneArrays, frames, kind_arr, idx, point):
    """World-space geometric normal of primitive ``idx`` at world ``point``.

    Reproduces rt.rs:776-793 (object-space normal mapped back through the
    same instance matrix, then normalized) including the box face-selection
    quirk at rt.rs:414-444 where the missing ``else`` lets the z-test
    override a matched x/y face.
    """
    M = frames[idx]                     # (R,3,3)
    ipos = scene.inst_pos[idx]          # (R,3)
    kind = kind_arr[idx]                # (R,)
    hp = ipos + linalg.matvec(M, point - ipos)

    # sphere (rt.rs:447-451)
    n_sph = hp - ipos
    # plane (rt.rs:453-456): raw stored normal
    n_pln = scene.prim_a[idx]
    # box (rt.rs:414-444)
    p = (hp - ipos) * (2.0 / jnp.where(scene.prim_a[idx] == 0, 1.0, scene.prim_a[idx]))
    def _in(v, target):
        return jnp.abs(v - target) < EPS
    ex = jnp.array([1.0, 0.0, 0.0], point.dtype)
    ey = jnp.array([0.0, 1.0, 0.0], point.dtype)
    ez = jnp.array([0.0, 0.0, 1.0], point.dtype)
    zero3 = jnp.zeros_like(point)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    base = jnp.where(_in(px, 1.0)[..., None], ex,
           jnp.where(_in(px, -1.0)[..., None], -ex,
           jnp.where(_in(py, 1.0)[..., None], ey,
           jnp.where(_in(py, -1.0)[..., None], -ey, zero3))))
    # the z test is NOT chained to the x/y chain (missing `else`, rt.rs:435)
    n_box = jnp.where(_in(pz, 1.0)[..., None], ez,
            jnp.where(_in(pz, -1.0)[..., None], -ez, base))
    # triangle (rt.rs:459-466)
    n_tri = linalg.cross(scene.prim_b[idx] - scene.prim_a[idx],
                         scene.prim_c[idx] - scene.prim_a[idx])

    n_obj = jnp.where((kind == schema.KIND_SPHERE)[..., None], n_sph,
            jnp.where((kind == schema.KIND_PLANE)[..., None], n_pln,
            jnp.where((kind == schema.KIND_BOX)[..., None], n_box, n_tri)))
    return linalg.normalize(linalg.matvec(M, n_obj))


def uv_at(scene: SceneArrays, frames, kind_arr, idx, point):
    """Texture coordinates of primitive ``idx`` at world ``point``.

    rt.rs:468-548 / 795-809. Triangles/meshes are ``todo!()`` in the
    reference (they panic); here they return 0.
    """
    M = frames[idx]
    ipos = scene.inst_pos[idx]
    kind = kind_arr[idx]
    hp = ipos + linalg.matvec(M, point - ipos)

    # sphere (rt.rs:518-526)
    v = linalg.normalize(hp - ipos)
    uv_sph = jnp.stack([
        0.5 + 0.5 * jnp.arctan2(v[..., 0], -v[..., 1]) / jnp.pi,
        0.5 - 0.5 * v[..., 2],
    ], axis=-1)
    # plane (rt.rs:528-542): fract with negative wrap
    fx = (hp[..., 0] + 0.5) - jnp.trunc(hp[..., 0] + 0.5)
    fy = (hp[..., 1] + 0.5) - jnp.trunc(hp[..., 1] + 0.5)
    uv_pln = jnp.stack([jnp.where(fx < 0, 1.0 + fx, fx),
                        jnp.where(fy < 0, 1.0 + fy, fy)], axis=-1)
    # box cross-atlas (rt.rs:468-515)
    sizes = jnp.where(scene.prim_a[idx] == 0, 1.0, scene.prim_a[idx])
    p = (hp - ipos) * (2.0 / sizes)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    def _in(vv, target):
        return jnp.abs(vv - target) < EPS
    u_right = jnp.stack([(0.5 + 0.5 * py) / 4.0 + 2.0 / 4.0,
                         (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_left = jnp.stack([(0.5 - 0.5 * py) / 4.0,
                        (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_fwd = jnp.stack([(0.5 - 0.5 * px) / 4.0 + 3.0 / 4.0,
                       (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_back = jnp.stack([(0.5 + 0.5 * px) / 4.0 + 1.0 / 4.0,
                        (0.5 - 0.5 * pz) / 3.0 + 1.0 / 3.0], axis=-1)
    u_top = jnp.stack([(0.5 + 0.5 * px) / 4.0 + 1.0 / 4.0,
                       (0.5 - 0.5 * py) / 3.0], axis=-1)
    u_bot = jnp.stack([(0.5 + 0.5 * px) / 4.0 + 1.0 / 4.0,
                       (0.5 + 0.5 * py) / 3.0 + 2.0 / 3.0], axis=-1)
    # UV branches all return immediately in the reference, so plain chaining
    # (x, y, then z) is faithful here (rt.rs:475-514).
    uv_box = jnp.where(_in(px, 1.0)[..., None], u_right,
             jnp.where(_in(px, -1.0)[..., None], u_left,
             jnp.where(_in(py, 1.0)[..., None], u_fwd,
             jnp.where(_in(py, -1.0)[..., None], u_back,
             jnp.where(_in(pz, 1.0)[..., None], u_top,
             jnp.where(_in(pz, -1.0)[..., None], u_bot,
                       jnp.zeros_like(u_top)))))))

    uv = jnp.where((kind == schema.KIND_SPHERE)[..., None], uv_sph,
         jnp.where((kind == schema.KIND_PLANE)[..., None], uv_pln,
         jnp.where((kind == schema.KIND_BOX)[..., None], uv_box,
                   jnp.zeros_like(uv_sph))))
    return uv


def sample_texture(scene: SceneArrays, tex_id, uv):
    """Nearest-neighbor texel fetch (rt.rs:618-628).

    The reference does no clamping (out-of-range UVs would panic); indices
    are clamped into the texture here, which only matters at the exact seam
    ``u == 1.0``.
    """
    tid = jnp.maximum(tex_id, 0)
    w = scene.tex_w[tid]
    h = scene.tex_h[tid]
    x = jnp.clip((uv[..., 0] * w.astype(uv.dtype)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h.astype(uv.dtype)).astype(jnp.int32), 0, h - 1)
    idx = scene.tex_offset[tid] + x + y * w
    return scene.tex_data[idx]


def material_at(scene: SceneArrays, frames, kind_arr, idx, point):
    """Evaluate the full material of primitive ``idx`` at world ``point``.

    Returns a dict of color (albedo modulated by tex, rt.rs:811-818), rough,
    metal, glass, opacity, emit — each map read from the red channel
    (rt.rs:820-863) — plus the raw per-object ``metal`` scalar used by the
    dielectric-diffuse branch (rt.rs:564 reads ``obj.mat.metal`` unmapped).
    """
    m = scene.mat_id[idx]
    out = {
        "color": scene.mat_albedo[m],
        "rough": scene.mat_rough[m],
        "metal": scene.mat_metal[m],
        "glass": scene.mat_glass[m],
        "opacity": scene.mat_opacity[m],
        "emit": scene.mat_emit[m],
        "metal_scalar": scene.mat_metal[m],
    }
    if not scene.has_maps:
        return out
    uv = uv_at(scene, frames, kind_arr, idx, point)
    maps = scene.mat_maps[m]  # (R,6)
    if scene.map_slots[0]:
        tex_rgb = sample_texture(scene, maps[..., 0], uv)
        out["color"] = jnp.where((maps[..., 0] >= 0)[..., None],
                                 out["color"] * tex_rgb, out["color"])
    for slot, key in ((1, "rough"), (2, "metal"), (3, "glass"),
                      (4, "opacity"), (5, "emit")):
        if not scene.map_slots[slot]:
            continue  # statically absent: no gather compiled
        val = sample_texture(scene, maps[..., slot], uv)[..., 0]
        out[key] = jnp.where(maps[..., slot] >= 0, val, out[key])
    return out
