"""Quick single-config forward bench (default Mesh.json) for kernel A/Bs.

Same measurement as bench.py's per-config forward (fused samples via
fori_loop, min-of-repeats, dispatch overhead subtracted) but one scene and
fewer samples, so a culling experiment turns around in ~1 min.

Usage: python tools/mesh_bench.py [--scene Mesh] [--samples 16]
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
    p.add_argument("--scene", default="Mesh")
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--grad", action="store_true",
                   help="measure fwd+bwd (grad-accumulation) instead")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import (compile_camera,
                                                     compile_scene)
    from micro_raytracer_tpu.models.render import _pick_chunk, morton_ray_order
    from micro_raytracer_tpu.models.tracer import trace_radiance
    from micro_raytracer_tpu.ops import rng

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
    chunk = _pick_chunk(render_wh[0] * render_wh[1], scene)
    nw, nh = render_wh
    order = morton_ray_order(nw, nh)
    start = max(0, (nw * nh - chunk) // 2)
    pix = order[start:start + chunk]
    if pix.shape[0] < chunk:
        pix = np.concatenate([pix, np.zeros(chunk - pix.shape[0], np.int64)])
    ys, xs = np.divmod(pix, nw)
    coords = jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))
    key = rng.make_key(0)
    S = args.samples

    if args.grad:
        from micro_raytracer_tpu.parallel import shard

        scene0 = scene
        params, _ = shard.split_params(scene)

        def fwd(params, coords, key):
            def sample_grad(i):
                def loss_fn(p):
                    s = shard.merge_params(scene0, p)
                    rad = trace_radiance(s, cam, render_wh, bounce, loss,
                                         coords, jax.random.fold_in(key, i))
                    return jnp.mean(rad ** 2)
                return jax.grad(loss_fn)(params)

            zero = jax.tree_util.tree_map(jnp.zeros_like, params)

            def body(i, acc):
                return jax.tree_util.tree_map(jnp.add, acc, sample_grad(i))
            return jax.lax.fori_loop(0, S, body, zero)["mat_albedo"]

        fwd_j = jax.jit(fwd)
        scene = params  # first arg below
    else:
        def fwd(scene, coords, key):
            def body(i, acc):
                rad = trace_radiance(scene, cam, render_wh, bounce, loss,
                                     coords, jax.random.fold_in(key, i))
                return acc + rad
            return jax.lax.fori_loop(0, S, body,
                                     jnp.zeros((chunk, 3), jnp.float32))

        fwd_j = jax.jit(fwd)

    def sync(x):
        np.asarray(jax.device_get(x[0, 0]))

    sync(fwd_j(scene, coords, key))
    ts = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        sync(fwd_j(scene, coords, key))
        ts.append(time.perf_counter() - t0)
    raw = min(ts)

    tiny = jax.jit(lambda x: x + 1.0)
    sync(tiny(jnp.zeros((8, 128), jnp.float32)))
    bs = []
    for _ in range(8):
        t0 = time.perf_counter()
        sync(tiny(jnp.zeros((8, 128), jnp.float32)))
        bs.append(time.perf_counter() - t0)
    base = min(bs)
    eff = max(raw - base, 0.25 * raw)
    print(json.dumps({"scene": args.scene, "chunk": chunk, "samples": S,
                      "mode": "fwdbwd" if args.grad else "fwd",
                      "raw_ms": round(raw * 1e3, 1),
                      "dispatch_ms": round(base * 1e3, 2),
                      "rays_per_s": round(chunk * S / eff, 1)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
