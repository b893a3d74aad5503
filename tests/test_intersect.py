import jax.numpy as jnp
import numpy as np

from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.compiler import compile_scene
from micro_raytracer_tpu.ops import intersect


def scene_of(objs, lights=()):
    cfg = schema.SceneConfig.from_json(
        {"renderer": objs, "light": list(lights) or None})
    return compile_scene(cfg)


def hit_one(scene, orig, dirs):
    frames = intersect.build_frames(scene)
    return intersect.closest_hit(
        scene, frames, jnp.asarray([orig], jnp.float32), jnp.asarray([dirs], jnp.float32))


def test_sphere_hit():
    s = scene_of([{"type": "sphere", "r": 0.5}])
    h = hit_one(s, [0, -2, 0], [0, 1, 0])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t_entry[0]), 1.5, atol=1e-5)
    np.testing.assert_allclose(float(h.t_exit[0]), 2.5, atol=1e-5)


def test_sphere_inside_is_miss():
    # reference treats t0 < 0 as a miss even when t1 > 0 (rt.rs:353-355)
    s = scene_of([{"type": "sphere", "r": 1.0}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert not bool(h.hit[0])


def test_plane_double_sided():
    s = scene_of([{"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -1]}])
    h = hit_one(s, [0, 0, 0], [0, 0, -1])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t_entry[0]), 1.0, atol=1e-4)
    # from below, looking up: also hits (double-sided)
    h2 = hit_one(s, [0, 0, -2], [0, 0, 1])
    assert bool(h2.hit[0])


def test_box_entry_exit():
    s = scene_of([{"type": "box", "sizes": [1, 1, 1]}])
    h = hit_one(s, [0, -2, 0], [0, 1, 0])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t_entry[0]), 1.5, atol=1e-4)
    np.testing.assert_allclose(float(h.t_exit[0]), 2.5, atol=1e-4)


def test_box_from_inside_negative_entry():
    # slab test yields t0 < 0 when origin is inside; still a valid hit (rt.rs:327)
    s = scene_of([{"type": "box", "sizes": [2, 2, 2]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert bool(h.hit[0])
    assert float(h.t_entry[0]) < 0.0
    np.testing.assert_allclose(float(h.t_exit[0]), 1.0, atol=1e-4)


def test_triangle_hit_and_backface():
    vtx = [[-1, 1, -1], [1, 1, -1], [0, 1, 1]]
    s = scene_of([{"type": "triangle", "vtx": vtx}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t_entry[0]), 1.0, atol=1e-3)
    # Moller-Trumbore here is backface-inclusive (rt.rs:371-373)
    h2 = hit_one(s, [0, 2, 0], [0, -1, 0])
    assert bool(h2.hit[0])


def test_closest_among_two():
    s = scene_of([
        {"type": "sphere", "r": 0.5, "pos": [0, 3, 0]},
        {"type": "sphere", "r": 0.5, "pos": [0, 1.5, 0]},
    ])
    h = hit_one(s, [0, -2, 0], [0, 1, 0])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t_entry[0]), 3.0, atol=1e-5)


def test_mesh_group_exit():
    # two parallel triangles forming one mesh: entry = near, exit = far
    tri_near = [[-1, 1, -1], [1, 1, -1], [0, 1, 1]]
    tri_far = [[-1, 2, -1], [1, 2, -1], [0, 2, 1]]
    s = scene_of([{"type": "mesh", "mesh": [tri_near, tri_far]}])
    h = hit_one(s, [0, 0, 0], [0, 1, 0])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t_entry[0]), 1.0, atol=1e-3)
    np.testing.assert_allclose(float(h.t_exit[0]), 2.0, atol=1e-3)


def test_sphere_normal():
    s = scene_of([{"type": "sphere", "r": 0.5}])
    frames = intersect.build_frames(s)
    kinds = intersect._kind_array(s)
    n = intersect.normal_at(s, frames, kinds, jnp.array([0]), jnp.asarray([[0.0, -0.5, 0.0]]))
    np.testing.assert_allclose(np.asarray(n[0]), [0, -1, 0], atol=1e-5)


def test_box_normal_faces():
    s = scene_of([{"type": "box", "sizes": [1, 1, 1]}])
    frames = intersect.build_frames(s)
    kinds = intersect._kind_array(s)
    for point, expect in [([0.5, 0, 0], [1, 0, 0]), ([-0.5, 0, 0], [-1, 0, 0]),
                          ([0, 0.5, 0], [0, 1, 0]), ([0, 0, -0.5], [0, 0, -1])]:
        n = intersect.normal_at(s, frames, kinds, jnp.array([0]),
                                jnp.asarray([point], jnp.float32))
        np.testing.assert_allclose(np.asarray(n[0]), expect, atol=1e-4)


def test_instance_translation():
    # same sphere via instance list at two positions
    s = scene_of([{"type": "sphere", "r": 0.5,
                   "inst": [[[0, 0, 0], [0, 0, -1, 0]], [[2, 0, 0], [0, 0, -1, 0]]]}])
    h = hit_one(s, [2, -2, 0], [0, 1, 0])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t_entry[0]), 1.5, atol=1e-5)


def test_any_hit_occlusion():
    s = scene_of([{"type": "sphere", "r": 0.5, "pos": [0, 1, 0]}])
    frames = intersect.build_frames(s)
    occ = intersect.any_hit(s, frames, jnp.asarray([[0.0, -1.0, 0.0], [0.0, -1.0, 2.0]]),
                            jnp.asarray([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]]))
    assert bool(occ[0]) and not bool(occ[1])


def test_fetch_attrs_matches_gather_path():
    """One-hot attribute fetching must equal the gather-based lookups."""
    import jax

    d = {
        "renderer": [
            {"type": "sphere", "r": 0.4, "pos": [0, 1, 0],
             "mat": {"albedo": [0.9, 0.5, 0.1], "rough": 0.7, "emit": 0.2}},
            {"type": "box", "sizes": [1, 2, 1], "pos": [2, 0, 0],
             "dir": [0, 0.5, 0.5, 0], "mat": {"metal": 1.0}},
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -1],
             "mat": {"glass": 0.3, "opacity": 0.2}},
            {"type": "triangle", "vtx": [[0, 2, 0], [1, 2, 0], [0, 2, 1]]},
        ],
    }
    s = compile_scene(schema.SceneConfig.from_json(d))
    frames = intersect.build_frames(s)
    kinds = intersect._kind_array(s)
    attrs = intersect.prim_attributes(s, frames)

    key = jax.random.PRNGKey(3)
    orig = jax.random.uniform(key, (64, 3), minval=-3, maxval=3)
    dirs = jnp.asarray(
        np.random.default_rng(0).standard_normal((64, 3)), jnp.float32)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)

    hit = intersect.closest_hit(s, frames, orig, dirs)
    pt = orig + dirs * jnp.where(hit.hit, hit.t_entry, 1.0)[:, None]

    at = intersect.fetch_attrs(attrs, hit.idx_entry, s.n_prims)
    n_new = intersect.normal_from_attrs(at, pt)
    n_old = intersect.normal_at(s, frames, kinds, hit.idx_entry, pt)
    mask = jnp.isfinite(n_old).all(-1) & jnp.isfinite(n_new).all(-1)
    np.testing.assert_allclose(np.where(mask[:, None], n_new, 0),
                               np.where(mask[:, None], n_old, 0),
                               atol=1e-5)

    m_new = intersect.material_from_attrs(s, at, pt)
    m_old = intersect.material_at(s, frames, kinds, hit.idx_entry, pt)
    for k in ("color", "rough", "metal", "glass", "opacity", "emit"):
        np.testing.assert_allclose(np.asarray(m_new[k]), np.asarray(m_old[k]),
                                   atol=1e-6, err_msg=k)

    uv_new = intersect.uv_from_attrs(at, pt)
    uv_old = intersect.uv_at(s, frames, kinds, hit.idx_entry, pt)
    np.testing.assert_allclose(np.asarray(uv_new), np.asarray(uv_old), atol=1e-5)


def test_tri_mxu_matches_moller_trumbore(monkeypatch):
    """The Woop-transform matmul triangle sweep == the Moller-Trumbore sweep.

    Same hits, same t (up to float rounding), on a random rotated/translated
    mesh instance plus an interleaved sphere segment.
    """
    import jax

    rng_np = np.random.default_rng(0)
    tris = rng_np.uniform(-1, 1, (40, 3, 3)).astype(np.float32)
    s = scene_of([
        {"type": "mesh", "mesh": tris.tolist(), "dir": [0, 0.4, 0.6, 0.2],
         "pos": [0.2, -0.1, 0.3]},
        {"type": "sphere", "r": 0.3},
    ])
    frames = intersect.build_frames(s)
    o = jnp.asarray(rng_np.uniform(-2, 2, (256, 3)), jnp.float32)
    d = rng_np.normal(size=(256, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)

    monkeypatch.setenv("MRT_TRI_MXU", "0")
    t0a, t1a, oka = (np.asarray(x) for x in
                     intersect.intersect_all(s, frames, o, d))
    monkeypatch.setenv("MRT_TRI_MXU", "1")
    t0b, t1b, okb = (np.asarray(x) for x in
                     intersect.intersect_all(s, frames, o, d))

    np.testing.assert_array_equal(oka, okb)
    both = oka & okb
    np.testing.assert_allclose(np.where(both, t0a, 0.0),
                               np.where(both, t0b, 0.0), rtol=2e-4, atol=2e-5)

    # gradients flow through the matmul path's per-triangle constants
    def f(pos):
        import dataclasses
        s2 = dataclasses.replace(s, inst_pos=pos)
        fr = intersect.build_frames(s2)
        te, _, ok = intersect.intersect_all(s2, fr, o, d)
        return jnp.sum(jnp.where(ok, te, 0.0))

    g = np.asarray(jax.grad(f)(s.inst_pos))
    assert np.all(np.isfinite(g)) and np.abs(g).sum() > 0
