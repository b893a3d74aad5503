"""One bounce, the two fold formulations, and radiance gradients, on every
shared test scene (tests/scenes.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import Oracle
from scenes import NAMES, scenes, state
from micro_raytracer_tpu.models import schema, tracer
from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
from micro_raytracer_tpu.ops import intersect


def _compiled(name):
    return compile_scene(schema.SceneConfig.from_json(scenes()[name]))


@pytest.mark.parametrize("name", NAMES)
def test_fused_step_matches_oracle(name):
    """``fused_step_reference`` (f32, batched) == the scalar float64 port
    of one rt.rs bounce, lane by lane, from the same uniforms."""
    scene = _compiled(name)
    frames = intersect.build_frames(scene)
    attrs = intersect.prim_attributes(scene, frames)
    ray, A, B, u, u_emit = state(n=128, seed=3)
    decay = jnp.float32(0.85)
    (o2, d2, pwr2, _), A2, B2, live2 = jax.jit(
        lambda s, f, a, r, A, B, u, ue: tracer.fused_step_reference(
            s, f, a, decay, r, A, B, u, ue))(scene, frames, attrs, ray, A, B,
                                            u, u_emit)
    orc = Oracle(schema.RenderConfig.from_json({"scene": scenes()[name]}))
    o, d, pwr, live = (np.asarray(x) for x in ray)
    A, B, u, u_emit = (np.asarray(x) for x in (A, B, u, u_emit))
    n_live = 0
    for i in range(o.shape[0]):
        if live[i]:
            hit, no, nd, a, b = orc.step(o[i], d[i], float(pwr[i]), u[i],
                                         float(u_emit[i]))
        else:
            hit, a, b = False, np.ones(3), np.zeros(3)
        assert bool(live2[i]) == hit, i
        np.testing.assert_allclose(A2[i], A[i] * a, rtol=1e-3, atol=1e-5,
                                   err_msg=f"A lane {i}")
        np.testing.assert_allclose(B2[i], B[i] + A[i] * b, rtol=1e-3,
                                   atol=1e-5, err_msg=f"B lane {i}")
        np.testing.assert_allclose(pwr2[i], pwr[i] * 0.85, rtol=1e-6)
        if hit:
            n_live += 1
            np.testing.assert_allclose(o2[i], no, rtol=1e-3, atol=1e-4,
                                       err_msg=f"next origin lane {i}")
            np.testing.assert_allclose(d2[i], nd, rtol=1e-3, atol=1e-4,
                                       err_msg=f"next dir lane {i}")
    assert n_live > 10  # the state actually hits the scene


@pytest.mark.parametrize("name", NAMES)
def test_trace_fused_matches_record_path(name):
    """The forward-composed fold equals the record stack + reverse fold:
    same RNG draws, float reassociation only."""
    scene = _compiled(name)
    frames = intersect.build_frames(scene)
    attrs = intersect.prim_attributes(scene, frames)
    (o, d, _, _), _, _, _, _ = state(n=256, seed=5)
    k_trace, k_shade = jax.random.split(jax.random.PRNGKey(11))
    loss = jnp.float32(0.15)

    @jax.jit
    def both(o, d):
        fused = tracer.trace_fused(scene, frames, attrs, 4, o, d, loss,
                                   k_trace, k_shade)
        recs = tracer.trace_records(scene, frames, attrs, 4, o, d, loss,
                                    k_trace)
        return fused, tracer.shade_records(scene, recs, k_shade)

    fused, record = both(o, d)
    assert float(jnp.abs(record).max()) > 0
    np.testing.assert_allclose(np.asarray(fused), np.asarray(record),
                               rtol=1e-5, atol=1e-6)


# two differentiable leaves per scene whose perturbation changes no branch
# or hit decision (materials, lights, sky), so central differences of the
# stochastic estimator are exact up to float noise
_FD_FIELDS = {
    "opaque": ("light_pwr", "mat_albedo"),
    "glass": ("light_color", "sky_color"),
    "textured": ("mat_albedo", "light_pwr"),
    "glass_flat": ("sky_pwr", "light_pwr"),
    "textured_flat": ("sky_color", "light_color"),
}


@pytest.mark.parametrize("name,field", [(n, f) for n in NAMES
                                        for f in _FD_FIELDS[n]])
def test_radiance_gradient_matches_fd(name, field):
    scene = _compiled(name)
    cam = compile_camera(schema.CameraConfig.from_json({"pos": [0, -2, 0]}))
    xs, ys = np.meshgrid(np.arange(8, 56, 8), np.arange(8, 56, 8))
    coords = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1), jnp.float32)
    key = jax.random.PRNGKey(4)

    @jax.jit
    def loss(v):
        s = dataclasses.replace(scene, **{field: v})
        rad = tracer.trace_radiance(s, cam, (64, 64), 3, jnp.float32(0.15),
                                    coords, key)
        return jnp.mean(rad ** 2)

    x0 = getattr(scene, field)
    g = jax.grad(loss)(x0)
    direction = jnp.ones_like(x0)
    h = 1e-2
    fd = (float(loss(x0 + h * direction)) - float(loss(x0 - h * direction))) \
        / (2 * h)
    an = float(jnp.sum(g * direction))
    assert abs(an) > 1e-6, f"{field} gradient vanishes on {name}"
    assert abs(fd - an) <= 2e-3 * abs(an) + 1e-6, (fd, an)
