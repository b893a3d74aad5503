"""Scaling-efficiency benchmark over a device mesh.

Measures sharded-render rays/s at 1, 2, 4, ... devices and reports
efficiency vs linear scaling. By default this runs on the virtual CPU
mesh (``--platform cpu`` with 8 forced host devices) to exercise the
shard_map path; treat CPU numbers as a plumbing check, not device
numbers. ``--platform env`` measures the accelerators JAX finds.

Usage:
  python tools/scaling_bench.py [--devices 1,2,4,8] [--rays-per-dev 8192]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("--rays-per-dev", type=int, default=8192)
    p.add_argument("--bounce", type=int, default=4)
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--platform", default="cpu", choices=("cpu", "env"))
    args = p.parse_args(argv)

    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
    from micro_raytracer_tpu.parallel import shard
    from micro_raytracer_tpu.parallel.mesh import make_mesh
    from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR

    with open(os.path.join(EXAMPLES_DIR, "CornellBox.json")) as f:
        cfg = schema.RenderConfig.from_json(json.load(f))
    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    wh = (1080, 1080)
    key = jax.random.PRNGKey(0)

    results = []
    base_rate = None
    for nd in [int(v) for v in args.devices.split(",")]:
        if nd > len(jax.devices()):
            continue
        mesh = make_mesh(nd, sp=1)  # pure pixel-DP scaling
        fn = shard.make_sharded_render(mesh, wh, args.bounce)
        n_rays = args.rays_per_dev * nd
        ys, xs = np.divmod(np.arange(n_rays, dtype=np.int64) % (wh[0] * wh[1]),
                           wh[0])
        coords = jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))
        loss = jnp.float32(cfg.rt.loss)
        fn(scene, cam, loss, coords, key).block_until_ready()
        times = []
        for i in range(args.samples):
            t0 = time.perf_counter()
            fn(scene, cam, loss, coords,
               jax.random.fold_in(key, i)).block_until_ready()
            times.append(time.perf_counter() - t0)
        rate = n_rays / min(times)
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        results.append({"devices": nd, "rays_per_s": round(rate, 1),
                        "scaling_efficiency": round(eff, 3)})
        print(json.dumps(results[-1]))
    print(json.dumps({"platform": jax.default_backend(),
                      "min_efficiency": min(r["scaling_efficiency"]
                                            for r in results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
