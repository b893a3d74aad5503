"""Sharded rendering and differentiable training steps over a device mesh.

Pixel tiles shard over the ``dp`` axis (the reference's dim x dim job grid,
sampler.rs:39-74, reborn as ``shard_map``); independent path-tracing samples
shard over ``sp`` and are averaged with a ``psum``; parameter gradients are
``psum``-reduced over both axes, overlapped with the backward sweep by XLA.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map as _shard_map_new

    def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
        return _shard_map_new(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=check_rep)
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..models.tracer import trace_radiance

# Scene leaves treated as trainable in the training step — the
# differentiable surface: material params, light power/color, sky, and
# object transforms.
TRAINABLE_FIELDS = (
    "mat_albedo", "mat_rough", "mat_metal", "mat_glass", "mat_opacity",
    "mat_emit", "light_pwr", "light_color", "sky_color", "sky_pwr",
    "inst_pos", "inst_dir",
)


def split_params(scene):
    """Split a compiled scene into (trainable dict, remainder scene)."""
    params = {k: getattr(scene, k) for k in TRAINABLE_FIELDS}
    return params, scene


def merge_params(scene, params):
    return dataclasses.replace(scene, **params)


def make_sharded_render(mesh, render_wh, bounce):
    """Jitted sharded forward pass: coords sharded over dp, samples over sp.

    Returns ``fn(scene, cam, loss, coords, key) -> (R, 3)`` radiance averaged
    over the sp axis. ``coords`` leading dim must divide by mesh dp size.
    """

    def per_device(scene, cam, loss, coords, key):
        dp = jax.lax.axis_index("dp")
        sp = jax.lax.axis_index("sp")
        k = jax.random.fold_in(jax.random.fold_in(key, dp), sp)
        rad = trace_radiance(scene, cam, render_wh, bounce, loss, coords, k)
        return jax.lax.pmean(rad, "sp")

    fn = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P(), P("dp"), P()),
        out_specs=P("dp"),
        check_rep=False,
    )
    return jax.jit(fn)


def make_train_step(mesh, render_wh, bounce, lr=1e-2, remat=False):
    """Full differentiable render-and-fit step over the mesh.

    Inverse-rendering objective: L2 between rendered radiance and a target
    image shard. Gradients w.r.t. every trainable scene leaf are psum'd over
    (dp, sp) and applied with SGD. This is the "training step" analogue of
    the framework (per-pixel radiance differentiable w.r.t. materials,
    lights, sky, transforms).
    """

    def per_device(params, scene, cam, loss_cfg, coords, target, key):
        dp = jax.lax.axis_index("dp")
        sp = jax.lax.axis_index("sp")
        k = jax.random.fold_in(jax.random.fold_in(key, dp), sp)

        def loss_fn(p):
            s = merge_params(scene, p)
            # remat=False keeps the residuals (not yet measured against
            # remat on a GPU); pass remat=True for memory-constrained shapes
            rad = trace_radiance(s, cam, render_wh, bounce, loss_cfg, coords, k,
                                 remat=remat)
            rad = jax.lax.pmean(rad, "sp")  # average samples across sp chips
            return jnp.mean((rad - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.pmean(loss, "dp")
        grads = jax.lax.pmean(jax.lax.pmean(grads, "dp"), "sp")
        new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return loss, new_params

    fn = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("dp"), P("dp"), P()),
        out_specs=(P(), P()),
        check_rep=False,
    )
    return jax.jit(fn)
