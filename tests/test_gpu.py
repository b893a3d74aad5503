"""Tests that need an NVIDIA GPU; they skip elsewhere.

Run on the card with ``MRT_TEST_GPU=1 python -m pytest -m gpu tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
from micro_raytracer_tpu.models.tracer import trace_radiance
from micro_raytracer_tpu.ops import intersect

pytestmark = pytest.mark.gpu

_SCENE = {
    "renderer": [
        {"type": "sphere", "r": 0.4, "mat": {"glass": 0.08, "opacity": 0.0}},
        {"type": "box", "sizes": [0.3, 0.4, 0.5], "pos": [-0.6, 0.8, 0],
         "dir": [0, 0.5, 0.5, 0.1]},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.8]},
    ],
    "light": [{"type": "point", "pos": [0, -1, 1], "pwr": 0.6}],
}


def test_closest_hit_matches_cpu(gpu_device):
    scene = compile_scene(schema.SceneConfig.from_json(_SCENE))
    rng = np.random.default_rng(0)
    o = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = jax.jit(lambda s, o, d: intersect.closest_hit(
        s, intersect.build_frames(s), o, d))
    cpu = jax.devices("cpu")[0]
    got = f(*jax.device_put((scene, o, d), gpu_device))
    want = f(*jax.device_put((scene, o, d), cpu))
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(np.asarray(got.idx_entry),
                                  np.asarray(want.idx_entry))
    np.testing.assert_allclose(np.asarray(got.t_entry),
                               np.asarray(want.t_entry), rtol=1e-5)


def test_radiance_finite_on_gpu(gpu_device):
    scene = compile_scene(schema.SceneConfig.from_json(_SCENE))
    cam = compile_camera(schema.CameraConfig.from_json({"pos": [0, -2, 0]}))
    ys, xs = np.mgrid[0:64, 0:64]
    coords = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    rad = jax.jit(lambda s, c, k: trace_radiance(
        s, cam, (64, 64), 4, jnp.float32(0.15), c, k))(
        *jax.device_put((scene, coords, jax.random.PRNGKey(0)), gpu_device))
    assert rad.devices() == {gpu_device}
    assert bool(jnp.all(jnp.isfinite(rad))) and float(rad.max()) > 0
