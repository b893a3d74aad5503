"""Gradient check: the fused forward's gradients against the record path's.

``trace_radiance`` has two formulations of the same estimator (the
reference's rt.rs:867-898 composed with rt.rs:966-992): the forward-
composed fold (``tracer.trace_fused``, the default) and the record-
emitting reverse fold (``MRT_NO_FUSE=1``). Both draw identical RNG
streams, so their gradients must agree to float reassociation for every
trainable scene leaf; then both fwd+bwd routes are timed at a production
chunk.

Two mechanisms separate CHAOS from BUG on triangle scenes, where
cross-formulation comparison alone cannot bind:

* ``--pixels interior`` (the Mesh default): validation pixels are chosen
  so their whole 5x5 neighborhood primary-hits the SAME mesh group —
  paths that start on a mesh interior, away from silhouettes where a
  single winner-t ulp difference flips the whole path.
* a finite-difference SELF-check of the fused path: for leaves that
  enter no branch/hit decision (albedo, light pwr/color, sky) the paths
  are IDENTICAL under perturbation, so the directional central
  difference of the loss must match <grad, v> regardless of chaos. A
  mis-scaled backward fails this immediately; it needs no reference
  implementation at all.

Usage:
  python tools/grad_check.py [--platform cpu|env] [--scene CornellBox]
                             [--chunk 131072] [--samples 4]
Prints JSON lines: one per leaf (max abs/rel diff), FD lines, one
summary. Exit 0 iff every gate passes.

Note on CornellBox's zero leaves (inst_pos/mat_rough/...): with zero
analytic lights and a black sky, radiance is a sum of albedo/emission
products — the fold coefficients (rt.rs:966-992) carry no continuous
dependence on geometry, so position/rotation/rough gradients are
EXACTLY zero in both paths (which object a ray hits is discrete).
Lit-scene coverage for those leaves lives in the CPU suite
(tests/test_tracer.py, tests/test_gradients.py) and in --scene Default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR as EXAMPLES  # noqa: E402

# Per-scene defaults. Sphere silhouettes differentiate through
# ~1/sqrt(disc), so formulations that are algebraically equal but
# float-reassociated diverge %-level on grazing lanes; the per-leaf
# Monte-Carlo bound covers exactly those leaves. Mesh compares on
# INTERIOR pixels only (silhouette chaos is not an implementation
# property) and leans on the FD self-check for the backward's scale.
SCENE_DEFAULTS = {
    "CornellBox": {"gate": 5e-3, "pixels": "block"},
    "dof": {"gate": 5e-3, "pixels": "block"},
    "Mesh": {"gate": 2e-2, "pixels": "interior"},
}

# Leaves that enter NO branch or hit decision anywhere in the estimator
# (branches read emit/rough/opacity draws and geometry only): perturbing
# them leaves every path identical, so finite differences of the chaotic
# estimator are exact up to float noise and quadratic truncation.
FD_LEAVES = ("mat_albedo", "light_pwr", "light_color", "sky_color",
             "sky_pwr")


def _interior_coords(scene, cam, wh, n, jnp, np):
    """Pixels whose 5x5 neighborhood primary-hits one mesh group.

    Probed with the dense jnp closest-hit (oracle-validated) at pixel
    centers with centered aperture uniforms; the 2-px erosion margin
    covers the per-sample aperture jitter (Mesh.json aprt 0.008) and
    SSAA offsets so sampled rays stay interior too."""
    from micro_raytracer_tpu.models import camera as camera_mod, schema
    from micro_raytracer_tpu.ops import intersect

    W, H = wh
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = jnp.asarray(
        np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32))
    u = jnp.full((coords.shape[0], 2), 0.5, jnp.float32)
    orig, dirs = camera_mod.gen_rays(cam, wh, coords, u)
    frames = intersect.build_frames(scene)
    hit = intersect.closest_hit(scene, frames, orig, dirs,
                                need_exit=scene.any_refract)
    s = scene.seg(schema.KIND_TRIANGLE)
    idx = np.asarray(hit.idx_entry)
    gid = np.asarray(scene.group_id)[idx]
    in_tri = np.asarray(hit.hit) & (idx >= s.start) & (idx < s.stop)
    gmap = np.where(in_tri, gid, -1).reshape(H, W)
    inner = gmap >= 0
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            sh = np.roll(np.roll(gmap, dy, 0), dx, 1)
            inner &= sh == gmap
    inner[:2] = inner[-2:] = False
    inner[:, :2] = inner[:, -2:] = False
    iy, ix = np.nonzero(inner)
    if iy.size == 0:
        return None
    take = np.linspace(0, iy.size - 1, min(n, iy.size)).astype(np.int64)
    sel = np.stack([ix[take], iy[take]], -1).astype(np.float32)
    if sel.shape[0] < n:  # repeat to fill the requested ray count
        reps = -(-n // sel.shape[0])
        sel = np.tile(sel, (reps, 1))[:n]
    return sel


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default="env", choices=("cpu", "env"))
    p.add_argument("--scene", default="CornellBox")
    p.add_argument("--res", type=int, default=256,
                   help="square render res for the validation pass")
    p.add_argument("--chunk", type=int, default=131072,
                   help="rays per call for the timing pass")
    p.add_argument("--samples", type=int, default=4,
                   help="fused samples per timed call")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--skip-timing", action="store_true")
    p.add_argument("--gate", type=float, default=None,
                   help="worst-leaf relative-diff gate (per-scene default,"
                        " see SCENE_DEFAULTS)")
    p.add_argument("--pixels", default=None, choices=("block", "interior"),
                   help="validation pixel set (per-scene default)")
    p.add_argument("--fd-gate", type=float, default=0.05,
                   help="relative gate for the fused path's finite-"
                        "difference self-check on smooth leaves")
    p.add_argument("--no-fd", action="store_true")
    args = p.parse_args(argv)
    defaults = SCENE_DEFAULTS.get(args.scene, {})
    gate_arg = args.gate if args.gate is not None \
        else defaults.get("gate", 5e-3)
    pixels = args.pixels if args.pixels is not None \
        else defaults.get("pixels", "block")

    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
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
    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    bounce = cfg.rt.bounce
    loss = jnp.float32(cfg.rt.loss)
    wh = (args.res, args.res)
    key = rng.make_key(7)

    inner_coords = None
    if pixels == "interior":
        inner_coords = _interior_coords(scene, cam, wh, 8192, jnp, np)
        if inner_coords is None:
            print(json.dumps({"warn": "no interior pixels found; "
                                      "falling back to block"}))
            pixels = "block"

    def make_coords(n_rays):
        if pixels == "interior" and n_rays <= inner_coords.shape[0]:
            return jnp.asarray(inner_coords[:n_rays])
        # center-frame block: top-of-frame rows can be black in scenes
        # like CornellBox (no analytic lights), zeroing most grad leaves
        # and making the comparison vacuous
        start = max(0, (wh[0] * wh[1] - n_rays) // 2)
        ys, xs = np.divmod(start + np.arange(n_rays, dtype=np.int64), wh[0])
        return jnp.asarray(np.stack([xs % wh[0], ys % wh[1]], -1)
                           .astype(np.float32))

    def grads_fn(n_rays, n_samples, key_=None):
        coords = make_coords(n_rays)
        params, _ = shard.split_params(scene)
        k0 = key if key_ is None else key_

        def loss_fn(pp):
            s = shard.merge_params(scene, pp)

            def body(i, acc):
                rad = trace_radiance(s, cam, wh, bounce, loss, coords,
                                     jax.random.fold_in(k0, i))
                return acc + jnp.mean((rad - 0.25) ** 2)

            return jax.lax.fori_loop(0, n_samples, body, 0.0)

        return params, loss_fn

    def run(env, n_rays, n_samples, key_=None):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            params, loss_fn = grads_fn(n_rays, n_samples, key_)
            jf = jax.jit(jax.grad(loss_fn))
            g = jax.block_until_ready(jf(params))
            times = []
            if not args.skip_timing:
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    jax.block_until_ready(jf(params))
                    times.append(time.perf_counter() - t0)
            return jax.device_get(g), (min(times) if times else None)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def run_fd(env, n_rays, n_samples, h=2e-3):
        """Directional central differences of the fused path vs its own
        analytic grads, one line per smooth leaf. Same RNG both sides;
        these leaves change no path, so fd ~= <g, v> to float noise."""
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            params, loss_fn = grads_fn(n_rays, n_samples)
            jl = jax.jit(loss_fn)
            g = jax.device_get(jax.jit(jax.grad(loss_fn))(params))
            worst = 0.0
            for leaf in FD_LEAVES:
                if leaf not in params or np.asarray(params[leaf]).size == 0:
                    continue
                v = jnp.ones_like(params[leaf])
                pp = dict(params)
                pp[leaf] = params[leaf] + h * v
                lp = float(jl(pp))
                pp[leaf] = params[leaf] - h * v
                lm = float(jl(pp))
                fd = (lp - lm) / (2.0 * h)
                an = float(jnp.sum(g[leaf] * v))
                scale = max(abs(an), abs(fd))
                rel = abs(fd - an) / (scale + 1e-12)
                if scale > 1e-6:
                    worst = max(worst, rel)
                print(json.dumps({"fd_leaf": leaf, "fd": fd, "analytic": an,
                                  "rel": round(rel, 6)}))
            return worst
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    envs = {
        "fused": {"MRT_NO_FUSE": "0"},
        "record": {"MRT_NO_FUSE": "1"},
    }

    # --- gradient agreement at a small chunk --------------------------------
    n_val = 8192
    g_ref, _ = run(envs["record"], n_val, 2)
    # Monte-Carlo resampling scale: the SAME estimator with a fresh RNG
    # stream. Chaotic path splits between formulations flip a random
    # subset of (ray, sample) paths, so their difference is statistically
    # a (small) resampling — it must stay BELOW the estimator's own
    # full-resample noise per leaf, or the backward has a real bug.
    g_mc, _ = run(envs["record"], n_val, 2, key_=rng.make_key(1007))
    g_new, _ = run(envs["fused"], n_val, 2)
    worst, ok = 0.0, True
    worst_excess = 0.0
    for k in sorted(g_ref):
        a, b = np.asarray(g_ref[k]), np.asarray(g_new[k])
        m = np.asarray(g_mc[k])
        ad = float(np.max(np.abs(a - b))) if a.size else 0.0
        md = float(np.max(np.abs(a - m))) if a.size else 0.0
        scale = float(np.max(np.abs(a))) if a.size else 0.0
        rel = ad / (scale + 1e-12)
        mrel = md / (scale + 1e-12)
        # per-leaf gate: the full-resample Monte-Carlo noise (2x — the
        # single resample is itself one draw of a sqrt(2)*sigma
        # distribution) bounds legitimate divergence; a real backward bug
        # (mis-scaled term, >=10% systematic) exceeds it
        leaf_gate = max(gate_arg, 2.0 * mrel)
        if scale > 1e-6:
            worst = max(worst, rel)
            worst_excess = max(worst_excess, rel / leaf_gate)
            ok = ok and rel < leaf_gate
        print(json.dumps({"leaf": k, "max_abs_diff": ad,
                          "ref_scale": scale, "rel": round(rel, 6),
                          "mc_rel": round(mrel, 6),
                          "gate": round(leaf_gate, 6)}))

    # --- fused-path FD self-check -------------------------------------------
    fd_ok, fd_worst = True, None
    if not args.no_fd:
        fd_worst = run_fd(envs["fused"], n_val, 2)
        fd_ok = fd_worst < args.fd_gate
    print(json.dumps({"grad_match": ok, "worst_rel": round(worst, 6),
                      "worst_gate_excess": round(worst_excess, 4),
                      "gate": gate_arg, "pixels": pixels,
                      "fd_worst_rel": (round(fd_worst, 6)
                                       if fd_worst is not None else None),
                      "fd_gate": args.fd_gate, "fd_match": fd_ok}))

    # --- timing at production chunk ------------------------------------------
    if not args.skip_timing:
        _, t_ref = run(envs["record"], args.chunk, args.samples)
        _, t_new = run(envs["fused"], args.chunk, args.samples)
        paths = args.chunk * args.samples
        print(json.dumps({
            "chunk": args.chunk, "samples": args.samples,
            "device": jax.devices()[0].device_kind,
            "record_s": round(t_ref, 4), "fused_s": round(t_new, 4),
            "record_rays_per_s": round(paths / t_ref, 1),
            "fused_rays_per_s": round(paths / t_new, 1),
        }))
    return 0 if (ok and fd_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
