import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
from micro_raytracer_tpu.models.tracer import trace_radiance
from micro_raytracer_tpu.parallel import shard
from micro_raytracer_tpu.parallel.mesh import make_mesh
from micro_raytracer_tpu.utils.paths import REPO_ROOT

SCENE = {
    "renderer": [{"type": "sphere", "r": 0.5, "mat": {"rough": 1.0}}],
    "light": [{"type": "point", "pos": [-0.5, -1, 0.5], "pwr": 0.5}],
    "sky": {"color": [0.1, 0.1, 0.1]},
}


@pytest.fixture(scope="module")
def setup():
    scene = compile_scene(schema.SceneConfig.from_json(SCENE))
    cam = compile_camera(schema.CameraConfig.from_json({}))
    return scene, cam


def test_mesh_shapes():
    m = make_mesh(8)
    assert m.shape["dp"] * m.shape["sp"] == 8
    m1 = make_mesh(1)
    assert m1.shape == {"dp": 1, "sp": 1}


def test_sharded_render_matches_shape(setup):
    scene, cam = setup
    mesh = make_mesh(8)
    dp = mesh.shape["dp"]
    fn = shard.make_sharded_render(mesh, (64, 64), 2)
    coords = jnp.asarray(
        np.stack(np.divmod(np.arange(dp * 32, dtype=np.int64), 64), -1)[:, ::-1]
        .astype(np.float32))
    out = fn(scene, cam, jnp.float32(0.15), coords, jax.random.PRNGKey(0))
    assert out.shape == (dp * 32, 3)
    assert bool(jnp.all(jnp.isfinite(out)))


def test_train_step_runs_and_descends(setup):
    scene, cam = setup
    mesh = make_mesh(8)
    dp = mesh.shape["dp"]
    step = shard.make_train_step(mesh, (32, 32), 1, lr=0.1)
    params, _ = shard.split_params(scene)
    coords = jnp.asarray(
        np.stack(np.divmod(np.arange(dp * 16, dtype=np.int64), 32), -1)[:, ::-1]
        .astype(np.float32))
    target = jnp.zeros((dp * 16, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    loss0, p1 = step(params, scene, cam, jnp.float32(0.15), coords, target, key)
    assert np.isfinite(float(loss0))
    loss1, _ = step(p1, scene, cam, jnp.float32(0.15), coords, target, key)
    # one SGD step against a black target with the same key must not increase loss
    assert float(loss1) <= float(loss0) + 1e-6


def test_dryrun_multichip_entrypoint():
    import sys
    sys.path.insert(0, REPO_ROOT)
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import sys
    sys.path.insert(0, REPO_ROOT)
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1024, 3)
    assert bool(jnp.all(jnp.isfinite(out)))


def test_renderer_mesh_sharded_matches_single():
    """Renderer(mesh=...) shards rays over dp with no semantic change."""
    from micro_raytracer_tpu.models.render import Renderer
    from micro_raytracer_tpu.models import schema as sch

    cfg = sch.RenderConfig.from_json({
        "frame": {"res": [64, 32]},
        "scene": SCENE,
    })
    cfg.rt.sample = 2
    cfg.rt.bounce = 2
    single = Renderer(cfg, seed=3)
    single.execute_many(2)
    mesh = make_mesh(8, sp=1)
    sharded = Renderer(cfg, seed=3, mesh=mesh, chunk=single.chunk)
    sharded.execute_many(2)
    np.testing.assert_allclose(sharded.framebuffer(), single.framebuffer(),
                               rtol=1e-5, atol=1e-6)


def test_distributed_helpers_single_process():
    from micro_raytracer_tpu.parallel import distributed

    distributed.initialize()  # no-op single process
    assert distributed.is_primary()
    lo, hi = distributed.local_slice(100)
    assert (lo, hi) == (0, 100)


def test_renderer_sp_axis_matches_single(monkeypatch):
    """sp>1 shards a vmapped sample axis; the merged accumulator equals the
    single-device sum up to summation order (global RNG semantics are kept
    by GSPMD partitioning; threefry pinned — rbg draws are not
    partitioning-stable)."""
    monkeypatch.setenv("MRT_PRNG", "threefry2x32")
    from micro_raytracer_tpu.models.render import Renderer
    from micro_raytracer_tpu.models import schema as sch

    cfg = sch.RenderConfig.from_json({
        "frame": {"res": [64, 32]},
        "scene": SCENE,
    })
    cfg.rt.sample = 3
    cfg.rt.bounce = 2
    single = Renderer(cfg, seed=3)
    single.execute_many(3)       # odd count: exercises the sp remainder mask
    mesh = make_mesh(8, sp=2)
    sharded = Renderer(cfg, seed=3, mesh=mesh, chunk=single.chunk)
    sharded.execute_many(3)
    np.testing.assert_allclose(sharded.framebuffer(), single.framebuffer(),
                               rtol=1e-4, atol=1e-5)


def test_distributed_multiprocess():
    """Real jax.distributed: 2 local processes, coordinator, CPU gloo
    collectives, gathered frame identical to single-process (SURVEY §5d)."""
    import subprocess
    import sys

    rc = subprocess.call(
        [sys.executable, os.path.join(REPO_ROOT, "tools", "distributed_check.py"),
         "--procs", "2"], timeout=280)
    assert rc == 0


# refracting triangle-mesh scene: exercises the static-elision variants the
# single rough sphere can't (any_refract=True, triangle segment fallbacks)
_TETRA = [
    [[0.0, 0.0, 0.35], [-0.3, -0.2, -0.25], [0.3, -0.2, -0.25]],
    [[0.0, 0.0, 0.35], [0.3, -0.2, -0.25], [0.0, 0.3, -0.25]],
    [[0.0, 0.0, 0.35], [0.0, 0.3, -0.25], [-0.3, -0.2, -0.25]],
    [[-0.3, -0.2, -0.25], [0.3, -0.2, -0.25], [0.0, 0.3, -0.25]],
]
GLASS_MESH_SCENE = {
    "renderer": [
        {"type": "mesh", "mesh": _TETRA,
         "mat": {"glass": 0.08, "opacity": 0.0}},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.4],
         "mat": {"rough": 1.0, "albedo": [0.7, 0.6, 0.5]}},
    ],
    "light": [{"type": "point", "pos": [-0.4, -1, 0.8], "pwr": 0.6}],
    "sky": {"color": [0.2, 0.25, 0.35], "pwr": 0.5},
}


def _center_coords(n, wh=64):
    ys, xs = np.divmod(np.arange(n, dtype=np.int64), 8)
    return jnp.asarray(
        np.stack([xs + wh // 2 - 4, ys + wh // 2 - 4], -1).astype(np.float32))


def test_sharded_render_glass_mesh_matches_single():
    """dp/sp render equivalence on a refracting triangle scene."""
    scene = compile_scene(schema.SceneConfig.from_json(GLASS_MESH_SCENE))
    cam = compile_camera(schema.CameraConfig.from_json({}))
    mesh = make_mesh(8)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    fn = shard.make_sharded_render(mesh, (64, 64), 3)
    coords = _center_coords(dp * 16)
    key = jax.random.PRNGKey(2)
    out = np.asarray(fn(scene, cam, jnp.float32(0.15), coords, key))
    assert np.abs(out).max() > 1e-3, "scene rendered black"

    per = coords.shape[0] // dp
    want = []
    for d_i in range(dp):
        c = coords[d_i * per:(d_i + 1) * per]
        acc = 0.0
        for s_i in range(sp):
            k = jax.random.fold_in(jax.random.fold_in(key, d_i), s_i)
            acc = acc + trace_radiance(scene, cam, (64, 64), 3,
                                       jnp.float32(0.15), c, k)
        want.append(np.asarray(acc / sp))
    np.testing.assert_allclose(out, np.concatenate(want), rtol=1e-5,
                               atol=1e-6)


def test_train_step_glass_mesh_sharded_matches_single():
    """Sharded training-step equivalence on the refracting tetra-mesh
    scene: loss and updated params match the spelled-out single-device
    computation, and the gradients are nonzero (lit scene)."""
    scene = compile_scene(schema.SceneConfig.from_json(GLASS_MESH_SCENE))
    cam = compile_camera(schema.CameraConfig.from_json({}))
    mesh = make_mesh(8)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    step = shard.make_train_step(mesh, (64, 64), 2, lr=1e-2)
    params, _ = shard.split_params(scene)
    coords = _center_coords(dp * 16)
    target = jnp.zeros((coords.shape[0], 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    loss_cfg = jnp.float32(0.15)
    loss, new_params = step(params, scene, cam, loss_cfg, coords, target,
                            key)
    loss = float(loss)
    assert loss > 1e-3, "loss ~ 0: the equivalence below would be vacuous"
    delta = sum(float(jnp.sum(jnp.abs(new_params[k] - params[k])))
                for k in params)
    assert delta > 1e-6, "all gradient leaves are exactly zero"

    per = coords.shape[0] // dp

    def ref_loss(p):
        s = shard.merge_params(scene, p)
        losses = []
        for d_i in range(dp):
            c = coords[d_i * per:(d_i + 1) * per]
            tgt = target[d_i * per:(d_i + 1) * per]
            rad = 0.0
            for s_i in range(sp):
                k = jax.random.fold_in(jax.random.fold_in(key, d_i), s_i)
                rad = rad + trace_radiance(s, cam, (64, 64), 2, loss_cfg,
                                           c, k)
            losses.append(jnp.mean((rad / sp - tgt) ** 2))
        return jnp.mean(jnp.stack(losses))

    ref_l, ref_g = jax.jit(jax.value_and_grad(ref_loss))(params)
    assert abs(loss - float(ref_l)) < 1e-4 * max(1.0, abs(float(ref_l)))
    for k in params:
        want = np.asarray(params[k] - 1e-2 * ref_g[k])
        np.testing.assert_allclose(np.asarray(new_params[k]), want,
                                   rtol=2e-4, atol=1e-6, err_msg=k)
