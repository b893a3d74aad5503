"""Scene -> padded SoA device arrays.

This is the boundary the reference crosses in ``RenderWrapper::unwrap``
(reference src/parser.rs:838-937): JSON wrappers become runtime objects.
Here it becomes a *compiler* instead: the scene graph is flattened into dense,
kind-sorted primitive buffers so the tracer is pure data-parallel array code —
no trait objects, no per-object dispatch, no BVH (meshes are brute-forced
over padded triangle rows, mirroring the reference's exact hit semantics via
``group_id``).

Layout
------
Primitive rows are sorted by kind: ``[spheres | planes | boxes | triangles]``
with static per-segment counts. Each (object, instance) pair contributes one
row per primitive (meshes contribute one row per triangle per instance, all
sharing a ``group_id`` so entry/exit hits reproduce rt.rs:740-772).

All float buffers are differentiable pytree leaves; int buffers ride along as
non-differentiable leaves; Python-int counts are static metadata.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from . import schema

# Segment order == kind code (schema.KIND_*).
N_KINDS = 4
_SEG_PAD = 8  # pad each kind segment to a multiple of 8 rows


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "prim_a", "prim_b", "prim_c", "prim_r", "inst_pos", "inst_dir",
        "prim_valid", "group_id", "mat_id",
        "mat_albedo", "mat_rough", "mat_metal", "mat_glass", "mat_opacity",
        "mat_emit", "mat_maps",
        "tex_data", "tex_offset", "tex_w", "tex_h",
        "light_is_dir", "light_pos", "light_dir", "light_pwr", "light_color",
        "sky_color", "sky_pwr",
    ],
    meta_fields=["kind_counts", "n_lights", "has_maps", "any_refract",
                 "map_slots"],
)
@dataclass
class SceneArrays:
    """Compiled scene: dense kind-sorted primitive/material/light tables."""

    # --- primitives, P rows, sorted by kind ---
    prim_a: Any    # (P,3) sphere: center-unused | plane: n | box: sizes | tri: v0
    prim_b: Any    # (P,3) tri: v1
    prim_c: Any    # (P,3) tri: v2
    prim_r: Any    # (P,)  sphere radius
    inst_pos: Any  # (P,3) instance position
    inst_dir: Any  # (P,4) instance direction [w,x,y,z]
    prim_valid: Any  # (P,) bool padding mask
    group_id: Any  # (P,) int32 (object, instance) pair id — mesh exit semantics
    mat_id: Any    # (P,) int32 into the material table

    # --- materials, M rows ---
    mat_albedo: Any   # (M,3)
    mat_rough: Any    # (M,)
    mat_metal: Any    # (M,)
    mat_glass: Any    # (M,)
    mat_opacity: Any  # (M,)
    mat_emit: Any     # (M,)
    mat_maps: Any     # (M,6) int32 texture ids for tex/rmap/mmap/gmap/omap/emap; -1 = none

    # --- texture atlas (flat texel buffer) ---
    tex_data: Any    # (N_texels, 3) f32
    tex_offset: Any  # (T,) int32
    tex_w: Any       # (T,) int32
    tex_h: Any       # (T,) int32

    # --- lights, L rows (unpadded; L may be 0) ---
    light_is_dir: Any  # (L,) bool
    light_pos: Any     # (L,3)
    light_dir: Any     # (L,3)
    light_pwr: Any     # (L,)
    light_color: Any   # (L,3)

    # --- sky ---
    sky_color: Any  # (3,)
    sky_pwr: Any    # ()

    # --- static metadata ---
    kind_counts: tuple  # padded rows per kind segment, sums to P
    n_lights: int
    has_maps: bool
    # True iff any material can refract (opacity<1, glass>0, or an
    # opacity/glass map). Static: opaque scenes compile without the whole
    # exit-hit path (fetch, normal, refraction) in the tracer.
    any_refract: bool = True
    # per-map-slot presence (tex/rmap/mmap/gmap/omap/emap): absent slots
    # compile without their per-ray texture gather (most scenes use 1-2
    # of the 6 slots)
    map_slots: tuple = (True,) * 6

    @property
    def n_prims(self) -> int:
        return sum(self.kind_counts)

    def seg(self, kind: int) -> slice:
        start = sum(self.kind_counts[:kind])
        return slice(start, start + self.kind_counts[kind])


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["pos", "dir", "fov", "gamma", "exp", "aprt", "foc"],
    meta_fields=[],
)
@dataclass
class CameraArrays:
    pos: Any   # (3,)
    dir: Any   # (4,)
    fov: Any   # ()
    gamma: Any
    exp: Any
    aprt: Any
    foc: Any


def compile_camera(cam: schema.CameraConfig) -> CameraArrays:
    f32 = lambda v: jnp.asarray(v, dtype=jnp.float32)
    return CameraArrays(
        pos=f32(cam.pos), dir=f32(cam.dir), fov=f32(cam.fov), gamma=f32(cam.gamma),
        exp=f32(cam.exp), aprt=f32(cam.aprt), foc=f32(cam.foc),
    )


def compile_scene(scene: schema.SceneConfig) -> SceneArrays:
    """Flatten a :class:`~.schema.SceneConfig` into :class:`SceneArrays`."""
    # -- collect rows per kind --
    rows = {k: {"a": [], "b": [], "c": [], "r": [], "ipos": [], "idir": [],
                "group": [], "mat": []} for k in range(N_KINDS)}
    group_counter = 0

    # -- material table + texture atlas --
    mat_albedo, mat_scalar = [], {k: [] for k in ("rough", "metal", "glass", "opacity", "emit")}
    mat_maps = []
    textures = []  # list of (H, W, 3) arrays

    def add_texture(arr) -> int:
        textures.append(np.asarray(arr, np.float32))
        return len(textures) - 1

    for obj in scene.objects:
        m = obj.mat
        mid = len(mat_albedo)
        mat_albedo.append(np.asarray(m.albedo, np.float32))
        for k in mat_scalar:
            mat_scalar[k].append(float(getattr(m, k)))
        mat_maps.append([
            add_texture(getattr(m, key)) if getattr(m, key) is not None else -1
            for key in schema.MaterialConfig.MAP_KEYS
        ])

        kind = schema._KIND_NAMES[obj.kind]
        if obj.kind == "mesh":
            tris = obj.geometry["mesh"]  # (T,3,3)
        # one group_id per (object, instance); only mesh instances push
        # more than one primitive row per group
        for ipos, idir in obj.instances:
            gid = group_counter
            group_counter += 1
            bucket = rows[kind]

            def push(a, b, c, r):
                bucket["a"].append(a)
                bucket["b"].append(b)
                bucket["c"].append(c)
                bucket["r"].append(r)
                bucket["ipos"].append(ipos)
                bucket["idir"].append(idir)
                bucket["group"].append(gid)
                bucket["mat"].append(mid)

            z3 = np.zeros(3, np.float32)
            if obj.kind == "sphere":
                push(z3, z3, z3, obj.geometry["r"])
            elif obj.kind == "plane":
                push(obj.geometry["n"], z3, z3, 0.0)
            elif obj.kind == "box":
                push(obj.geometry["sizes"], z3, z3, 0.0)
            elif obj.kind == "triangle":
                v = obj.geometry["vtx"]
                push(v[0], v[1], v[2], 0.0)
            elif obj.kind == "mesh":
                for t in range(tris.shape[0]):
                    push(tris[t, 0], tris[t, 1], tris[t, 2], 0.0)

    # An empty scene still gets one all-invalid sphere segment so every
    # downstream gather/argmin is well-formed (all rays miss).
    if not any(rows[k]["a"] for k in range(N_KINDS)):
        z3 = np.zeros(3, np.float32)
        rows[schema.KIND_SPHERE]["a"].append(z3)
        rows[schema.KIND_SPHERE]["b"].append(z3)
        rows[schema.KIND_SPHERE]["c"].append(z3)
        rows[schema.KIND_SPHERE]["r"].append(0.0)
        rows[schema.KIND_SPHERE]["ipos"].append(z3)
        rows[schema.KIND_SPHERE]["idir"].append(schema.BACKWARD4.copy())
        rows[schema.KIND_SPHERE]["group"].append(-1)
        rows[schema.KIND_SPHERE]["mat"].append(0)
        placeholder = True
    else:
        placeholder = False

    # -- pad each kind segment --
    kind_counts = []
    cat = {key: [] for key in ("a", "b", "c", "r", "ipos", "idir", "group", "mat", "valid")}
    for k in range(N_KINDS):
        n = len(rows[k]["a"])
        n_pad = max(_SEG_PAD, -(-n // _SEG_PAD) * _SEG_PAD) if n else 0
        kind_counts.append(n_pad)
        if n_pad == 0:
            continue
        cat["a"].append(_pad_rows(np.asarray(rows[k]["a"], np.float32).reshape(n, 3) if n else np.zeros((0, 3), np.float32), n_pad))
        cat["b"].append(_pad_rows(np.asarray(rows[k]["b"], np.float32).reshape(n, 3) if n else np.zeros((0, 3), np.float32), n_pad))
        cat["c"].append(_pad_rows(np.asarray(rows[k]["c"], np.float32).reshape(n, 3) if n else np.zeros((0, 3), np.float32), n_pad))
        cat["r"].append(_pad_rows(np.asarray(rows[k]["r"], np.float32), n_pad))
        cat["ipos"].append(_pad_rows(np.asarray(rows[k]["ipos"], np.float32).reshape(n, 3) if n else np.zeros((0, 3), np.float32), n_pad))
        # padded rows need a unit-norm dir so instance_mat stays finite
        idir = np.asarray(rows[k]["idir"], np.float32).reshape(n, 4) if n else np.zeros((0, 4), np.float32)
        idir_pad = np.tile(schema.BACKWARD4, (n_pad - n, 1)).astype(np.float32)
        cat["idir"].append(np.concatenate([idir, idir_pad], axis=0))
        # padding rows get group -1 so they never join a real group
        cat["group"].append(np.concatenate(
            [np.asarray(rows[k]["group"], np.int32), np.full(n_pad - n, -1, np.int32)]))
        cat["mat"].append(_pad_rows(np.asarray(rows[k]["mat"], np.int32), n_pad))
        cat["valid"].append(np.arange(n_pad) < n)

    def concat(key, empty_shape, dtype):
        if cat[key]:
            return np.concatenate(cat[key], axis=0).astype(dtype)
        return np.zeros(empty_shape, dtype)

    prim_a = concat("a", (0, 3), np.float32)
    prim_b = concat("b", (0, 3), np.float32)
    prim_c = concat("c", (0, 3), np.float32)
    prim_r = concat("r", (0,), np.float32)
    inst_pos = concat("ipos", (0, 3), np.float32)
    inst_dir = concat("idir", (0, 4), np.float32)
    group_id = concat("group", (0,), np.int32)
    mat_id = concat("mat", (0,), np.int32)
    prim_valid = concat("valid", (0,), bool)
    if placeholder:
        prim_valid = np.zeros_like(prim_valid)

    # -- material table (at least one row so gathers are well-formed) --
    M = max(1, len(mat_albedo))
    mat_albedo_np = _pad_rows(np.asarray(mat_albedo, np.float32).reshape(len(mat_albedo), 3), M) if mat_albedo else np.ones((1, 3), np.float32)
    mat_scal_np = {k: _pad_rows(np.asarray(v, np.float32), M) if v else np.zeros(M, np.float32)
                   for k, v in mat_scalar.items()}
    if not mat_scalar["opacity"]:
        mat_scal_np["opacity"] = np.ones(M, np.float32)
    mat_maps_np = (_pad_rows(np.asarray(mat_maps, np.int32).reshape(len(mat_maps), 6), M)
                   if mat_maps else np.full((1, 6), -1, np.int32))
    if mat_maps and len(mat_maps) < M:
        mat_maps_np[len(mat_maps):] = -1

    # -- texture atlas --
    offs, ws, hs, flat = [], [], [], []
    cursor = 0
    for t in textures:
        h, w = t.shape[:2]
        offs.append(cursor)
        ws.append(w)
        hs.append(h)
        flat.append(t.reshape(-1, 3))
        cursor += h * w
    if flat:
        tex_data = np.concatenate(flat, axis=0)
    else:
        tex_data = np.zeros((1, 3), np.float32)
        offs, ws, hs = [0], [1], [1]

    lights = scene.lights
    L = len(lights)

    j = lambda v, dt=jnp.float32: jnp.asarray(v, dtype=dt)
    return SceneArrays(
        prim_a=j(prim_a), prim_b=j(prim_b), prim_c=j(prim_c), prim_r=j(prim_r),
        inst_pos=j(inst_pos), inst_dir=j(inst_dir),
        prim_valid=jnp.asarray(prim_valid), group_id=j(group_id, jnp.int32),
        mat_id=j(mat_id, jnp.int32),
        mat_albedo=j(mat_albedo_np), mat_rough=j(mat_scal_np["rough"]),
        mat_metal=j(mat_scal_np["metal"]), mat_glass=j(mat_scal_np["glass"]),
        mat_opacity=j(mat_scal_np["opacity"]), mat_emit=j(mat_scal_np["emit"]),
        mat_maps=j(mat_maps_np, jnp.int32),
        tex_data=j(tex_data), tex_offset=j(offs, jnp.int32),
        tex_w=j(ws, jnp.int32), tex_h=j(hs, jnp.int32),
        light_is_dir=jnp.asarray([l.kind == "dir" for l in lights], dtype=bool).reshape(L),
        light_pos=j(np.asarray([l.pos for l in lights], np.float32).reshape(L, 3)),
        light_dir=j(np.asarray([l.dir for l in lights], np.float32).reshape(L, 3)),
        light_pwr=j(np.asarray([l.pwr for l in lights], np.float32).reshape(L)),
        light_color=j(np.asarray([l.color for l in lights], np.float32).reshape(L, 3)),
        sky_color=j(scene.sky.color), sky_pwr=j(scene.sky.pwr),
        kind_counts=tuple(kind_counts), n_lights=L,
        has_maps=bool(textures),
        map_slots=tuple(
            bool(np.any(mat_maps_np[:, slot] >= 0)) for slot in range(6)),
        any_refract=any(
            o.mat.opacity != 1.0 or o.mat.glass != 0.0
            or o.mat.omap is not None or o.mat.gmap is not None
            for o in scene.objects),
    )
