"""Grad-of-sample-loop vs loop-of-grads: same gradients, different cost.

The bench (and a naive trainer) differentiates a loss that sums K samples
inside one ``fori_loop`` — XLA stacks every sample's trace residuals
before the backward walks them. Accumulating per-sample grads instead
(grad inside the loop) keeps one sample's residuals live at a time.
Gradients are identical (grad of a sum); this prints both timings and the
max relative difference.

Usage: python tools/gradshape_check.py [--scene CornellBox] [--samples 16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR as EXAMPLES  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="CornellBox")
    p.add_argument("--rays", type=int, default=131072)
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import (compile_camera,
                                                     compile_scene)
    from micro_raytracer_tpu.models.tracer import trace_radiance
    from micro_raytracer_tpu.ops import rng
    from micro_raytracer_tpu.parallel import shard

    with open(f"{EXAMPLES}/{args.scene}.json") as f:
        cfg = schema.RenderConfig.from_json(json.load(f))
    if args.scene == "CornellBox":
        cfg.frame.res = (1080, 1080)
        cfg.frame.ssaa = 1.0
    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    render_wh = cfg.frame.render_res
    bounce = cfg.rt.bounce
    loss = jnp.float32(cfg.rt.loss)
    R, S = args.rays, args.samples
    key = rng.make_key(0)
    coords = jnp.stack([jnp.arange(R, dtype=jnp.float32) % render_wh[0],
                        (jnp.arange(R, dtype=jnp.float32) // render_wh[0])
                        % render_wh[1]], -1)
    params, _ = shard.split_params(scene)

    def sample_loss(p, k):
        s = shard.merge_params(scene, p)
        rad = trace_radiance(s, cam, render_wh, bounce, loss, coords, k)
        return jnp.mean(rad ** 2)

    def grad_of_loop(params, key):
        def loss_fn(p):
            def body(i, acc):
                return acc + sample_loss(p, jax.random.fold_in(key, i))
            return jax.lax.fori_loop(0, S, body, 0.0)
        return jax.grad(loss_fn)(params)

    def loop_of_grads(params, key):
        zero = jax.tree_util.tree_map(jnp.zeros_like, params)

        def body(i, acc):
            g = jax.grad(sample_loss)(params, jax.random.fold_in(key, i))
            return jax.tree_util.tree_map(jnp.add, acc, g)
        return jax.lax.fori_loop(0, S, body, zero)

    def sync(x):
        leaf = jax.tree_util.tree_leaves(x)[0]
        np.asarray(jax.device_get(leaf[(0,) * leaf.ndim]))

    def best(f, *a):
        out = f(*a)
        sync(out)
        ts = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            sync(f(*a))
            ts.append(time.perf_counter() - t0)
        return min(ts), out

    tiny = jax.jit(lambda x: x + 1.0)
    t0, _ = best(tiny, jnp.zeros((8, 128), jnp.float32))
    t_a, g_a = best(jax.jit(grad_of_loop), params, key)
    t_b, g_b = best(jax.jit(loop_of_grads), params, key)
    rel = max((float(jnp.max(jnp.abs(x - y)) /
                     (jnp.max(jnp.abs(x)) + 1e-20))
               for x, y in zip(jax.tree_util.tree_leaves(g_a),
                               jax.tree_util.tree_leaves(g_b))
               if x.size), default=0.0)
    print(json.dumps({
        "scene": args.scene, "rays": R, "samples": S,
        "dispatch_ms": round(t0 * 1e3, 2),
        "grad_of_loop_ms_per_sample": round((t_a - t0) / S * 1e3, 3),
        "loop_of_grads_ms_per_sample": round((t_b - t0) / S * 1e3, 3),
        "max_rel_diff": rel,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
