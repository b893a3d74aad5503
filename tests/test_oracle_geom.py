"""Oracle validation for the geometry paths the round-1 suite only smoked:
the box cross-atlas UVs (all six faces) and mesh entry/exit refraction.

The atlas test is deterministic (pure UV math vs oracle.Obj.uv,
rt.rs:468-515); the mesh tests are expectation comparisons like
tests/test_oracle.py.
"""

import numpy as np
import jax
import jax.numpy as jnp

from oracle import Oracle, Obj, inst_mat
from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.compiler import compile_scene
from micro_raytracer_tpu.ops import intersect

from test_oracle import _oracle, _ours


def test_box_atlas_uv_matches_oracle_all_faces():
    """uv_from_attrs == oracle Obj.uv on every face of a rotated box."""
    sizes = [0.5, 0.3, 0.8]
    dir4 = [0.0, 0.4, 0.55, 0.2]
    ipos = np.array([0.15, -0.2, 0.4])
    cfg = schema.SceneConfig.from_json({
        "renderer": [{"type": "box", "sizes": sizes, "pos": ipos.tolist(),
                      "dir": dir4}],
    })
    scene = compile_scene(cfg)
    frames = intersect.build_frames(scene)
    attrs = intersect.prim_attributes(scene, frames)
    row = scene.seg(schema.KIND_BOX).start

    obj = Obj(cfg.objects[0])
    M = inst_mat(np.asarray(dir4, np.float64))
    Minv = np.linalg.inv(M)
    sz = np.asarray(sizes, np.float64)

    rng = np.random.default_rng(3)
    pts, want = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            for _ in range(4):
                q = rng.uniform(-0.9, 0.9, 3)
                q[axis] = sign
                hp = ipos + q * sz / 2.0          # object-space face point
                p = ipos + Minv @ (hp - ipos)      # back to world space
                pts.append(p)
                want.append(obj.uv(M, ipos, p))
    pts = np.asarray(pts, np.float32)

    at = intersect.fetch_attrs(attrs, jnp.full((len(pts),), row, jnp.int32),
                               scene.n_prims)
    got = np.asarray(intersect.uv_from_attrs(at, jnp.asarray(pts)))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)

    # the gather-based twin must agree too
    kind_arr = jnp.full((scene.n_prims,), schema.KIND_BOX, jnp.int32)
    got2 = np.asarray(intersect.uv_at(
        scene, frames, kind_arr, jnp.full((len(pts),), row, jnp.int32),
        jnp.asarray(pts)))
    np.testing.assert_allclose(got2, np.asarray(want), atol=2e-4)


# a closed tetrahedron centered at the object origin (object space)
_TETRA = [
    [[0.0, 0.0, 0.35], [-0.3, -0.2, -0.25], [0.3, -0.2, -0.25]],
    [[0.0, 0.0, 0.35], [0.3, -0.2, -0.25], [0.0, 0.3, -0.25]],
    [[0.0, 0.0, 0.35], [0.0, 0.3, -0.25], [-0.3, -0.2, -0.25]],
    [[-0.3, -0.2, -0.25], [0.3, -0.2, -0.25], [0.0, 0.3, -0.25]],
]


def test_glass_mesh_refraction_matches_oracle():
    """Refraction through a mesh: entry at the nearest triangle, exit at the
    farthest triangle of the SAME mesh group (rt.rs:740-772, 1054-1058)."""
    cfg = schema.RenderConfig.from_json({
        "frame": {"res": [64, 64]},
        "scene": {
            "renderer": [
                {"type": "mesh", "mesh": _TETRA,
                 "mat": {"glass": 0.08, "opacity": 0.0}},
                {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.4],
                 "mat": {"rough": 1.0, "albedo": [0.7, 0.6, 0.5]}},
            ],
            "light": [{"type": "point", "pos": [-0.4, -1, 0.8], "pwr": 0.6}],
            "sky": {"color": [0.2, 0.25, 0.35], "pwr": 0.5},
        },
    })
    cfg.rt.bounce = 4
    pix = [(32, 32), (32, 38), (27, 30)]
    a = _oracle(cfg, pix, 300)
    b = _ours(cfg, pix, 2000)
    np.testing.assert_allclose(b, a, atol=0.03, rtol=0.3)


def test_textured_box_render_matches_oracle():
    """Checker texture through the box cross-atlas in the full path."""
    checker = {"w": 4, "h": 3, "dat": [
        [1, 1, 1], [0.1, 0.1, 0.1], [1, 1, 1], [0.1, 0.1, 0.1],
        [0.1, 0.1, 0.1], [1, 1, 1], [0.1, 0.1, 0.1], [1, 1, 1],
        [1, 1, 1], [0.1, 0.1, 0.1], [1, 1, 1], [0.1, 0.1, 0.1],
    ]}
    cfg = schema.RenderConfig.from_json({
        "frame": {"res": [64, 64], "cam": {"pos": [0, -1.6, 0.4]}},
        "scene": {
            "renderer": [
                {"type": "box", "sizes": [0.5, 0.5, 0.5],
                 "dir": [0, 0.45, 0.55, 0.1],
                 "mat": {"tex": checker, "rough": 1.0}},
                {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.4],
                 "mat": {"rough": 1.0}},
            ],
            "light": [{"type": "point", "pos": [-0.5, -1.2, 0.9], "pwr": 0.7}],
            "sky": {"color": [0.15, 0.18, 0.25], "pwr": 0.4},
        },
    })
    cfg.rt.bounce = 2
    pix = [(32, 34), (36, 30), (28, 38), (32, 26)]
    a = _oracle(cfg, pix, 250)
    b = _ours(cfg, pix, 1500)
    np.testing.assert_allclose(b, a, atol=0.03, rtol=0.3)


def test_mesh_radiance_mxu_matches_mt_sweep(monkeypatch):
    """Full tracer equality between the matmul and Moller-Trumbore sweeps."""
    from micro_raytracer_tpu.models.compiler import compile_camera
    from micro_raytracer_tpu.models.tracer import trace_radiance

    cfg = schema.RenderConfig.from_json({
        "frame": {"res": [64, 64]},
        "scene": {
            "renderer": [
                {"type": "mesh", "mesh": _TETRA,
                 "mat": {"glass": 0.08, "opacity": 0.0}},
                {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.4],
                 "mat": {"rough": 1.0}},
            ],
            "light": [{"type": "point", "pos": [-0.4, -1, 0.8], "pwr": 0.6}],
            "sky": {"color": [0.2, 0.25, 0.35], "pwr": 0.5},
        },
    })
    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    xs, ys = np.meshgrid(np.arange(8, 56, 4), np.arange(8, 56, 4))
    coords = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1), jnp.float32)
    key = jax.random.PRNGKey(2)

    def run():
        return np.asarray(trace_radiance(scene, cam, (64, 64), 4,
                                         jnp.float32(0.15), coords, key))

    monkeypatch.setenv("MRT_TRI_MXU", "0")
    a = run()
    monkeypatch.setenv("MRT_TRI_MXU", "1")
    b = run()
    # identical stochastic choices; tiny t differences can flip EPS-window
    # face tests only at geometric boundaries (none in this view)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_resort_radiance_bitwise_identical(monkeypatch):
    """MRT_RESORT=1 (mid-trace wavefront re-sort) is a pure permutation.

    Each ray keeps its own uniform stream across lane permutations and the
    frame values are gathered back to ray order, so radiance must be
    BITWISE identical to the unsorted trace — same stochastic choices,
    same float op order per ray. (Default stays off.)
    """
    from micro_raytracer_tpu.models.compiler import compile_camera
    from micro_raytracer_tpu.models.tracer import trace_radiance

    cfg = schema.RenderConfig.from_json({
        "frame": {"res": [64, 64]},
        "scene": {
            "renderer": [
                {"type": "mesh", "mesh": _TETRA,
                 "mat": {"glass": 0.08, "opacity": 0.0}},
                {"type": "sphere", "r": 0.3, "pos": [0.6, 0.3, 0.2],
                 "mat": {"rough": 0.5, "albedo": [0.8, 0.4, 0.3]}},
                {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.4],
                 "mat": {"rough": 1.0}},
            ],
            "light": [{"type": "point", "pos": [-0.4, -1, 0.8], "pwr": 0.6}],
            "sky": {"color": [0.2, 0.25, 0.35], "pwr": 0.5},
        },
    })
    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    xs, ys = np.meshgrid(np.arange(8, 56, 4), np.arange(8, 56, 4))
    coords = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1), jnp.float32)
    key = jax.random.PRNGKey(2)

    def run():
        return np.asarray(trace_radiance(scene, cam, (64, 64), 5,
                                         jnp.float32(0.15), coords, key))

    monkeypatch.setenv("MRT_RESORT", "0")
    a = run()
    monkeypatch.setenv("MRT_RESORT", "1")
    b = run()
    np.testing.assert_array_equal(a, b)


def test_minecraft_mini_composite_matches_oracle():
    """Minecraft-mini: instancing x mesh x texture maps composed in ONE
    scene (rt.rs:725-793 + 811-863 together) — two instanced checker-
    textured boxes (one rotated), a glass tetra mesh, a dir light and a
    lit sky. Covers the interaction no single-feature oracle test
    composes; pixels chosen on each object (probed via closest_hit)."""
    checker = {"w": 2, "h": 2, "dat": [[1, 1, 1], [0.2, 0.2, 0.2],
                                       [0.2, 0.2, 0.2], [1, 1, 1]]}
    cfg = schema.RenderConfig.from_json({
        "frame": {"res": [64, 64], "cam": {"pos": [0, -1.6, 0.25]}},
        "scene": {
            "renderer": [
                {"type": "box", "sizes": [0.3, 0.3, 0.3],
                 "inst": [[[-0.5, 0.2, -0.2], [0, 0, -1, 0]],
                          [[0.5, 0.3, -0.2], [0, 0.6, 0.4, 0]]],
                 "mat": {"tex": checker, "rough": 0.8}},
                {"type": "mesh", "mesh": _TETRA, "pos": [0, -0.1, 0.3],
                 "mat": {"glass": 0.08, "opacity": 0.0}},
                {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.4],
                 "mat": {"rough": 1.0}},
            ],
            "light": [{"type": "dir", "dir": [0.3, 0.5, -1], "pwr": 0.6}],
            "sky": {"color": [0.15, 0.2, 0.3], "pwr": 0.5},
        },
    })
    cfg.rt.bounce = 4
    # (x, y): glass mesh / left box / rotated right box / open plane
    pix = [(32, 28), (18, 42), (44, 42), (10, 50)]
    a = _oracle(cfg, pix, 300)
    b = _ours(cfg, pix, 1800)
    np.testing.assert_allclose(b, a, atol=0.03, rtol=0.3)
