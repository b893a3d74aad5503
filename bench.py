"""Benchmark: rays/s per device across the example scenes in ``examples/``.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "fwd_rays_per_s": N, "configs": {...}, "device": {...}, ...}

The headline value is CornellBox 1080x1080 forward+backward rays/s per
device ("rays" = primary paths, one per pixel-sample, matching the
reference's unit of work — reference src/sampler.rs:28-78; each path
carries bounce+1 closest-hit sweeps plus per-light shadow sweeps).
``configs`` reports forward AND forward+backward throughput for every
scene of ``CONFIGS`` that ``examples/`` holds.

Measures the production dispatch shape: fused per-pixel samples in one
device call via ``fori_loop`` (the Renderer's execute_many path) with the
production RNG (``rng.make_key``). Per-sample time is the median slope
between calls of two fused sample counts (see ``_slope``), so the fixed
per-call cost cancels; that cost is also measured and reported. Every
timing ends in ``jax.block_until_ready``.

The bench refuses to run without a GPU: a CPU number is not a device
number. The reference publishes no numbers; vs_baseline is against an
estimated 2e6 paths/s for the Rust renderer on its default 24-thread pool.
"""

import json
import os
import sys
import time

os.environ.setdefault("MRT_NO_COMPILE_CACHE", "0")

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_RAYS_PER_S = 2.0e6  # estimated Rust reference, 24 CPU threads
SAMPLES_FWD = 64   # forward calls amortize dispatch like production renders
SAMPLES_BWD = 64   # per-sample grads accumulate in-loop: residency is one
                   # sample's residuals regardless of the fused count
SAMPLES_BWD_AUX = 16  # non-headline configs: fewer fused samples, same slope

# CornellBox (the headline) is measured first; the JSON reports configs in
# canonical order regardless.
CONFIGS = ["CornellBox", "Default", "dof", "CornellBox2", "Mesh",
           "Instance", "Minecraft"]
REPORT_ORDER = ["Default", "dof", "CornellBox", "CornellBox2", "Mesh",
                "Instance", "Minecraft"]
if os.environ.get("MRT_BENCH_CONFIGS"):  # dev subset, e.g. "CornellBox"
    CONFIGS = [c for c in CONFIGS
               if c in os.environ["MRT_BENCH_CONFIGS"].split(",")]


def _load(name):
    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR

    path = os.path.join(EXAMPLES_DIR, f"{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        cfg = schema.RenderConfig.from_json(json.load(f))
    if name == "CornellBox":
        cfg.frame.res = (1080, 1080)
        cfg.frame.ssaa = 1.0
    return cfg


def _coords(chunk, render_wh):
    # production ray layout: a middle slice of the Morton-ordered frame
    # (the Renderer's chunking); middle rather than edge because edge
    # regions can be all-sky (black) in some scenes
    from micro_raytracer_tpu.models.render import morton_ray_order

    nw, nh = render_wh
    order = morton_ray_order(nw, nh)
    start = max(0, (nw * nh - chunk) // 2)
    pix = order[start:start + chunk]
    if pix.shape[0] < chunk:
        pix = np.concatenate([pix, np.zeros(chunk - pix.shape[0], np.int64)])
    ys, xs = np.divmod(pix, nw)
    return jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))


def _time_once(fn, *args):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def _slope(fn_hi, fn_lo, s_hi, s_lo, *args, pairs=7):
    """Marginal seconds per unit of work between two fused counts.

    Interleaves hi/lo calls so each difference pairs adjacent draws, then
    takes the median pair — robust to slow drift and to outliers in
    either direction. Returns (median, min) per unit."""
    jax.block_until_ready(fn_hi(*args))
    jax.block_until_ready(fn_lo(*args))
    diffs = []
    for _ in range(pairs):
        t_hi = _time_once(fn_hi, *args)
        t_lo = _time_once(fn_lo, *args)
        diffs.append(t_hi - t_lo)
    diffs.sort()
    med = diffs[len(diffs) // 2] if pairs % 2 else 0.5 * (
        diffs[pairs // 2 - 1] + diffs[pairs // 2])
    return med / (s_hi - s_lo), min(diffs) / (s_hi - s_lo)


def _dispatch_overhead():
    """Fixed cost of one jitted dispatch+sync, from a trivial one-op program."""
    x = jax.block_until_ready(jnp.ones((8,), jnp.float32))
    f = jax.jit(lambda v: v * 1.0000001)
    jax.block_until_ready(f(x))
    return min(_time_once(f, x) for _ in range(8))


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (found {dev.platform}); refusing to report "
              "a device number", file=sys.stderr)
        return 1

    from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
    from micro_raytracer_tpu.models.render import _pick_chunk
    from micro_raytracer_tpu.models.tracer import trace_radiance
    from micro_raytracer_tpu.ops import rng
    from micro_raytracer_tpu.parallel import shard
    from micro_raytracer_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    key = rng.make_key(0)
    overhead = _dispatch_overhead()
    per_config = {}
    headline = {}

    for name in CONFIGS:
        cfg = _load(name)
        if cfg is None:  # scene not in examples/ yet
            continue
        scene = compile_scene(cfg.scene)
        cam = compile_camera(cfg.frame.cam)
        render_wh = cfg.frame.render_res
        bounce = cfg.rt.bounce
        loss = jnp.float32(cfg.rt.loss)
        chunk = _pick_chunk(render_wh[0] * render_wh[1], scene)
        coords = _coords(chunk, render_wh)
        is_head = name == "CornellBox"

        def fwd_n(S):
            def f(scene, coords, key, _S=S):
                def body(i, acc):
                    rad = trace_radiance(scene, cam, render_wh, bounce,
                                         loss, coords,
                                         jax.random.fold_in(key, i))
                    return acc + rad

                return jax.lax.fori_loop(0, _S, body,
                                         jnp.zeros((chunk, 3), jnp.float32))
            return jax.jit(f)

        S_LO = max(1, SAMPLES_FWD // 4)
        fwd_j = fwd_n(SAMPLES_FWD)
        fwd_raw = _time_once(fwd_j, scene, coords, key)
        per_s, _ = _slope(fwd_j, fwd_n(S_LO), SAMPLES_FWD, S_LO,
                          scene, coords, key, pairs=5)
        rays = chunk / per_s if per_s > 0 else None
        entry = {"fwd_rays_per_s": round(rays, 1) if rays else None,
                 "chunk": chunk, "bounce": bounce,
                 "n_prims": scene.n_prims,
                 "raw_call_ms": round(fwd_raw * 1e3, 1)}

        # forward+backward: grads w.r.t. every trainable scene leaf, per-
        # sample grads summed in-loop (identical gradients to
        # differentiating the summed loss — tools/gradshape_check.py —
        # but only ONE sample's trace residuals are ever live)
        params, _ = shard.split_params(scene)
        S_B = SAMPLES_BWD if is_head else SAMPLES_BWD_AUX

        def fwdbwd_n(S):
            def f(params, coords, key, _S=S):
                def sample_grad(i):
                    def loss_fn(p):
                        s = shard.merge_params(scene, p)
                        rad = trace_radiance(s, cam, render_wh, bounce,
                                             loss, coords,
                                             jax.random.fold_in(key, i))
                        return jnp.mean(rad ** 2)

                    return jax.grad(loss_fn)(params)

                zero = jax.tree_util.tree_map(jnp.zeros_like, params)

                def body(i, acc):
                    return jax.tree_util.tree_map(jnp.add, acc,
                                                  sample_grad(i))

                return jax.lax.fori_loop(0, _S, body, zero)
            return jax.jit(f)

        B_LO = max(1, S_B // 4)
        fwdbwd_j = fwdbwd_n(S_B)
        bwd_raw = _time_once(fwdbwd_j, params, coords, key)
        per_s_b, _ = _slope(fwdbwd_j, fwdbwd_n(B_LO), S_B, B_LO,
                            params, coords, key,
                            pairs=9 if is_head else 5)
        rays_b = chunk / per_s_b if per_s_b > 0 else None
        entry["fwdbwd_rays_per_s"] = round(rays_b, 1) if rays_b else None
        entry["fwdbwd_raw_call_ms"] = round(bwd_raw * 1e3, 1)

        per_config[name] = entry
        if is_head:
            headline["fwd_rays_per_s"] = entry["fwd_rays_per_s"]
            headline["fwdbwd_rays_per_s"] = entry["fwdbwd_rays_per_s"]

    if not per_config:
        print("bench: no scene of CONFIGS in examples/", file=sys.stderr)
        return 1
    if not headline:  # dev subset without CornellBox: first config stands in
        headline = dict(per_config[next(iter(per_config))])
    value = headline["fwdbwd_rays_per_s"]
    print(json.dumps({
        "metric": "cornellbox_1080_rays_per_s_per_device_fwdbwd",
        "value": value,
        "unit": "rays/s",
        "vs_baseline": round(value / BASELINE_RAYS_PER_S, 3)
        if value else None,
        "fwd_rays_per_s": headline["fwd_rays_per_s"],
        "configs": {k: per_config[k] for k in REPORT_ORDER
                    if k in per_config},
        "dispatch_overhead_ms": round(overhead * 1e3, 3),
        "samples_per_call": {"fwd": SAMPLES_FWD, "bwd": SAMPLES_BWD,
                             "bwd_aux": SAMPLES_BWD_AUX},
        "jax_version": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
