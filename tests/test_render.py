import json
import os

import numpy as np
import pytest

from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.render import Renderer, render_image

from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR as EXAMPLES


def small_default(res=(96, 54), sample=2, ssaa=1.0):
    path = os.path.join(EXAMPLES, "Default.json")
    if not os.path.exists(path):
        pytest.skip("missing Default.json")
    with open(path) as f:
        cfg = schema.RenderConfig.from_json(json.load(f))
    cfg.frame.res = res
    cfg.frame.ssaa = ssaa
    cfg.rt.sample = sample
    return cfg


def test_render_default_smoke():
    cfg = small_default()
    img = render_image(cfg)
    assert img.shape == (54, 96, 3) and img.dtype == np.uint8
    # the lit sphere must produce bright pixels near the center
    center = img[17:37, 28:68].astype(np.float32)
    assert center.max() > 40
    # corners look at black sky
    assert img[0, 0].max() <= 10


def test_progressive_accumulation_and_state():
    cfg = small_default(sample=4)
    r = Renderer(cfg, seed=1)
    r.execute()
    r.execute()
    assert r.count == 2
    img2 = r.img()
    assert img2.shape == (54, 96, 3)

    # checkpoint / resume round trip
    path = "/tmp/mrt_state.npz"
    r.save_state(path)
    r2 = Renderer(cfg, seed=1)
    r2.load_state(path)
    assert r2.count == 2
    np.testing.assert_array_equal(r2.img(), img2)


def test_morton_layout_maps_slots_to_pixels():
    """Ray slots are Morton-ordered; frame assembly must invert it exactly.

    Stuff each accumulator row with its target pixel's flat index and check
    ``framebuffer`` puts every row at that pixel — a wrong permutation (or a
    missing inverse) scrambles the image while leaving every statistic
    (goldens' MAE included) almost unchanged, so this is the direct test.
    """
    import jax.numpy as jnp

    from micro_raytracer_tpu.models.render import morton_ray_order

    cfg = small_default(res=(97, 53))  # odd sizes: exercise the bounds filter
    r = Renderer(cfg)
    nw, nh = r.render_wh
    order = morton_ray_order(nw, nh)
    assert np.array_equal(np.sort(order), np.arange(nw * nh))
    # Z-order locality: any aligned 256-slot run spans a small bounding box
    ys, xs = np.divmod(order[:256], nw)
    assert (xs.max() - xs.min() + 1) * (ys.max() - ys.min() + 1) <= 1024
    flat = np.zeros((r.n_chunks * r.chunk, 3), np.float32)
    flat[: r.n_pix, 0] = order.astype(np.float32)
    per = flat.reshape(r.n_chunks, r.chunk, 3)
    r._accum = jnp.asarray(per)
    got = r.framebuffer()[:, :, 0]
    want = np.arange(nw * nh, dtype=np.float32).reshape(nh, nw)
    np.testing.assert_array_equal(got, want)


def test_load_state_rejects_other_layout():
    cfg = small_default()
    r = Renderer(cfg)
    r.execute()
    path = "/tmp/mrt_state_layout.npz"
    r.save_state(path)
    data = dict(np.load(path))
    data["layout"] = "rowmajor"
    np.savez(path, **data)
    with pytest.raises(ValueError, match="ray layout"):
        Renderer(cfg).load_state(path)


def test_ssaa_downsample_shape():
    cfg = small_default(res=(64, 36), sample=1, ssaa=2.0)
    img = render_image(cfg)
    assert img.shape == (36, 64, 3)


def test_seed_determinism():
    cfg = small_default(sample=1)
    a = render_image(cfg, seed=5)
    b = render_image(cfg, seed=5)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [
    "Default", "CornellBox", "CornellBox2", "dof", "Mesh", "Minecraft",
    "Instance",
])
def test_all_examples_render_smoke(name):
    """Every shipped example scene renders end-to-end at tiny res.

    Exercises the full tracer over the reference's whole feature matrix:
    textures + maps (dof/Mesh/Minecraft), flattened meshes (Mesh),
    instancing (Instance/Minecraft), DOF (dof), glass/metal (CornellBox2).
    """
    path = os.path.join(EXAMPLES, f"{name}.json")
    if not os.path.exists(path):
        pytest.skip(f"missing {name}.json")
    with open(path) as f:
        cfg = schema.RenderConfig.from_json(json.load(f))
    cfg.frame.res = (32, 18)
    cfg.frame.ssaa = 1.0
    cfg.rt.sample = 1
    cfg.rt.bounce = min(cfg.rt.bounce, 3)
    img = render_image(cfg)
    assert img.shape == (18, 32, 3) and img.dtype == np.uint8
    assert np.isfinite(img.astype(np.float64)).all()
    assert img.max() > 0  # every example scene has some lit content


@pytest.mark.parametrize("spec,n_pix", [
    ({"renderer": [{"type": "sphere", "r": 0.5}]}, 1080 * 1080),
    ({"renderer": [{"type": "sphere", "r": 0.5}]}, 100),
    ({"renderer": [{"type": "mesh", "mesh": [[[0, 0, 0], [1, 0, 0],
                                              [0, 1, 0]]] * 300}],
      "light": [{"type": "point"}] * 4}, 1280 * 720),
])
def test_pick_chunk_budget(spec, n_pix):
    """Chunks are whole multiples of 1024 rays, at most 2^17, no larger
    than the padded frame, and keep rays x rows x lights in budget."""
    from micro_raytracer_tpu.models.compiler import compile_scene
    from micro_raytracer_tpu.models.render import _pick_chunk
    from micro_raytracer_tpu.ops import intersect

    scene = compile_scene(schema.SceneConfig.from_json(spec))
    c = _pick_chunk(n_pix, scene)
    assert c % 1024 == 0 and 1024 <= c <= 1 << 17
    assert c <= -(-n_pix // 1024) * 1024
    n_tri = scene.kind_counts[schema.KIND_TRIANGLE]
    per_ray = scene.n_prims * max(1, scene.n_lights)
    budget = (1 << 27) // 6 if intersect._use_tri_mxu(n_tri) else (1 << 24) // 3
    assert c == 1024 or c * per_ray <= budget


def test_img_runs_on_device_and_matches_host_tonemap():
    """img() finalizes on the device; it must equal tonemapping the host
    framebuffer with the same function."""
    import jax.numpy as jnp

    from micro_raytracer_tpu.ops import tonemap

    cfg = small_default(sample=2)
    r = Renderer(cfg, seed=3)
    r.execute_many(2)
    img = r.img()
    want = np.asarray(tonemap.finalize(
        jnp.asarray(r.framebuffer()), jnp.float32(2), r.cam.gamma, r.cam.exp,
        cfg.frame.res))
    np.testing.assert_array_equal(img, want)
    assert img.max() > 0
