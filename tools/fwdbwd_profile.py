"""Device-trace breakdown of the PRODUCTION fwd+bwd step (bench headline
shape): trace_radiance grad through the whole-trace megakernel pair, with
grad-accumulation over a few samples. Prints per-op device time so the
forward kernel / backward kernel / XLA glue split is visible.

Usage: python tools/fwdbwd_profile.py [--scene CornellBox] [--samples 4]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR as EXAMPLES  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="CornellBox")
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--fwd-only", action="store_true",
                   help="profile the forward only")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
    from micro_raytracer_tpu.models.render import _pick_chunk, morton_ray_order
    from micro_raytracer_tpu.models.tracer import trace_radiance
    from micro_raytracer_tpu.ops import rng
    from micro_raytracer_tpu.parallel import shard
    from micro_raytracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

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
    params, _ = shard.split_params(scene)
    S = args.samples

    if args.fwd_only:
        def run(params, coords, key):
            def body(i, acc):
                rad = trace_radiance(scene, cam, render_wh, bounce, loss,
                                     coords, jax.random.fold_in(key, i))
                return acc + rad

            return jax.lax.fori_loop(0, S, body,
                                     jnp.zeros((chunk, 3), jnp.float32))
    else:
        def run(params, coords, key):
            def sample_grad(i):
                def loss_fn(p):
                    s = shard.merge_params(scene, p)
                    rad = trace_radiance(s, cam, render_wh, bounce, loss,
                                         coords, jax.random.fold_in(key, i))
                    return jnp.mean(rad ** 2)

                return jax.grad(loss_fn)(params)

            zero = jax.tree_util.tree_map(jnp.zeros_like, params)

            def body(i, acc):
                return jax.tree_util.tree_map(jnp.add, acc, sample_grad(i))

            return jax.lax.fori_loop(0, S, body, zero)

    f = jax.jit(run)

    def sync(x):
        leaf = jax.tree_util.tree_leaves(x)[0]
        np.asarray(jax.device_get(leaf[(0,) * leaf.ndim]))

    sync(f(params, coords, key))

    tmp = tempfile.mkdtemp(prefix="mrt_fwdbwd_")
    jax.profiler.start_trace(tmp)
    sync(f(params, coords, key))
    jax.profiler.stop_trace()

    files = glob.glob(f"{tmp}/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace produced", file=sys.stderr)
        return 1
    with gzip.open(files[0], "rt") as fh:
        tr = json.load(fh)
    tot = defaultdict(float)
    cnt = defaultdict(int)
    pid_names = {}
    for ev in tr.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev["args"].get("name", "")
    dev_pids = {p for p, n in pid_names.items()
                if "/device" in n.lower() or "gpu" in n.lower()}
    for ev in tr.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        if dev_pids and ev.get("pid") not in dev_pids:
            continue
        tot[ev["name"]] += ev.get("dur", 0) / 1e3
        cnt[ev["name"]] += 1
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:args.top]
    total = sum(tot.values())
    print(f"chunk={chunk} samples={S} bounce={bounce}")
    print(f"{'ms':>9} {'n':>5} {'ms/samp':>8}  name   (sum {total:.1f} ms,"
          f" {total / S:.2f} ms/sample, "
          f"{chunk * S / total * 1e3 / 1e6:.1f}M rays/s device-side)")
    for name, ms in rows:
        print(f"{ms:9.3f} {cnt[name]:5d} {ms / S:8.3f}  {name[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
