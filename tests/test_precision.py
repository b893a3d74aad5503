"""Geometry matmuls run at full f32 precision, and the package carries no
code for one accelerator family only."""

import dataclasses
import os
import re

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
from micro_raytracer_tpu.models.tracer import trace_radiance
from micro_raytracer_tpu.utils.paths import REPO_ROOT


def _sub_jaxprs(params):
    for v in params.values():
        for item in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def _dot_precisions(jaxpr):
    """Precision of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in _sub_jaxprs(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


def _is_highest(precision):
    highest = jax.lax.Precision.HIGHEST
    if isinstance(precision, (tuple, list)):
        return len(precision) > 0 and all(p == highest for p in precision)
    return precision == highest


@pytest.mark.parametrize("mode", ["forward", "gradient"])
def test_every_dot_general_is_highest_precision(mode):
    """A default-precision matmul may round its f32 inputs (TF32 tensor
    cores keep 10 mantissa bits), which breaks the EPS-window face tests;
    the Woop triangle sweep and the one-hot attribute fetch must both ask
    for HIGHEST, in the forward and in its transpose."""
    rng = np.random.default_rng(0)
    tris = rng.uniform(-0.5, 0.5, (64, 3, 3)).astype(np.float32)
    scene = compile_scene(schema.SceneConfig.from_json({
        "renderer": [
            {"type": "mesh", "mesh": tris.tolist(), "mat": {"rough": 0.5}},
            {"type": "sphere", "r": 0.3, "pos": [0.5, 0.2, 0],
             "mat": {"glass": 0.1, "opacity": 0.2}},
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.6]},
        ],
        "light": [{"type": "point", "pos": [0, -1, 1], "pwr": 0.5}],
    }))
    cam = compile_camera(schema.CameraConfig.from_json({}))
    coords = jnp.zeros((16, 2), jnp.float32)
    key = jax.random.PRNGKey(0)

    def f(albedo):
        s = dataclasses.replace(scene, mat_albedo=albedo)
        return jnp.sum(trace_radiance(s, cam, (8, 8), 2, jnp.float32(0.15),
                                      coords, key))

    fn = f if mode == "forward" else jax.grad(f)
    precisions = _dot_precisions(jax.make_jaxpr(fn)(scene.mat_albedo).jaxpr)
    # Woop sweep (2 per sweep) and attribute fetch (entry + exit) at least
    assert len(precisions) >= 4, precisions
    bad = [p for p in precisions if not _is_highest(p)]
    assert not bad, f"{len(bad)} of {len(precisions)} dot_generals: {bad[:3]}"


def _package_sources():
    pkg = os.path.join(REPO_ROOT, "micro_raytracer_tpu")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    yield os.path.relpath(path, REPO_ROOT), fh.read()


@pytest.mark.parametrize("pattern", [
    r"pallas\s*\.\s*tpu|pallas\s+import\s+tpu|\bpltpu\b",
    r"""platform\s*(==|!=|in)\s*[\(\["']*tpu""",
], ids=["no-tpu-pallas-import", "no-tpu-platform-branch"])
def test_package_has_no_tpu_only_code(pattern):
    hits = [f"{path}:{n + 1}" for path, src in _package_sources()
            for n, line in enumerate(src.splitlines())
            if re.search(pattern, line)]
    assert not hits, hits
