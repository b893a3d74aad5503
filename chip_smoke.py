"""Smoke test of the path tracer on an NVIDIA GPU, through its user paths.

One process holds the card and runs, in order:

1. device check — exits non-zero unless JAX's first device is a GPU;
2. kernels — the jitted plain closest-hit sweep (CornellBox, and a
   generated 1,000-triangle mesh) and one bounce step
   (``tracer.fused_step_reference``) at 1080x1080 = 1,166,400 camera rays,
   each compared with the same jitted function on the CPU backend; then
   full-depth radiance of a 128x128 centre crop over 64 samples on both;
3. CLI render — ``cli.main`` renders examples/CornellBox.json at 1080x1080
   to a PNG, which is decoded and checked;
4. HTTP service — the server runs in a thread (native transport when
   ``native/`` builds) and answers three POSTs with checked JPEGs;
5. fit step — three ``shard.make_train_step`` steps over all 1080x1080
   pixels of CornellBox on a 1-device mesh, and the step's gradients on a
   64x64 crop compared with the CPU backend.

Every phase prints one line with its wall time and the card's name and
power limit. Each comparison prints its error beside its tolerance. The
last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
any failure exits non-zero before it.

``--devices N`` (N > 1) runs only the multi-card phase: the CLI render on
a dp=N mesh, byte-identical to the one-card render, and a
dp x sp = (N/2) x 2 render and train step that match one device.

Usage:
  python chip_smoke.py [--out DIR]
  python chip_smoke.py --devices 4 [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

RES = 1080                 # CornellBox frame, 1080x1080
CROP = 128                 # full-depth radiance comparison crop
CROP_SAMPLES = 64
GRAD_CROP = 64             # fit-step gradient comparison crop
CLI_SAMPLES = 32
MESH_TRIS = (25, 20)       # torus tessellation: 2*25*20 = 1,000 triangles
TIMED_CALLS = 5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1,
                   help="number of cards; N > 1 runs only the multi-card "
                        "phase (default: 1, all one-card phases)")
    p.add_argument("--out", default="smoke_out",
                   help="directory for the rendered images")
    args = p.parse_args(argv)
    if args.devices < 1:
        p.error("--devices must be >= 1")
    if args.devices > 1 and args.devices % 2:
        p.error("--devices must be 1 or even (the sp=2 axis)")
    return args


def card_label() -> str:
    """``name, power.limit`` as nvidia-smi reports them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str, label: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s [{label}]",
          flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def report(name, err, tol, ok=None):
    """Print a measured error beside its tolerance; fail if over."""
    ok = err <= tol if ok is None else ok
    print(f"  {name}: {err:.4g} (tolerance {tol:.4g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: {err} over tolerance {tol}")


# Per-lane f32 comparisons across backends: a handful of lanes sit where
# the float32 result is ill-conditioned (slab and plane tests that cancel,
# normalizations of near-zero vectors), so a per-lane tolerance may be
# exceeded by a few lanes in a million. At most OUTLIER_SHARE of the lanes
# may go over, each by at most OUTLIER_CAP times the tolerance.
OUTLIER_SHARE = 1e-5
OUTLIER_CAP = 10.0


def report_lanes(name, err):
    """``err``: per-lane error in units of the tolerance (<= 1 passes)."""
    n_over = int((err > 1).sum())
    allowed = max(1, int(OUTLIER_SHARE * err.size))
    worst = float(err.max()) if err.size else 0.0
    ok = n_over <= allowed and worst <= OUTLIER_CAP
    print(f"  {name}: max {worst:.4g} x tolerance; {n_over} of {err.size} "
          f"lanes over (allowed {allowed}, each <= {OUTLIER_CAP:g}x) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: {n_over} lanes over tolerance, worst {worst}")


# ------------------------------------------------------------ helpers --
def load_example(name):
    from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR

    with open(os.path.join(EXAMPLES_DIR, f"{name}.json")) as f:
        return json.load(f)


def torus_mesh(n_u, n_v, r_major=0.3, r_minor=0.12):
    """(2*n_u*n_v, 3, 3) triangles of a torus around the z axis."""

    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts = np.stack([(r_major + r_minor * np.cos(vv)) * np.cos(uu),
                    (r_major + r_minor * np.cos(vv)) * np.sin(uu),
                    r_minor * np.sin(vv)], -1)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a, b = pts[i, j], pts[(i + 1) % n_u, j]
    c, d = pts[(i + 1) % n_u, (j + 1) % n_v], pts[i, (j + 1) % n_v]
    tris = np.concatenate([np.stack([a, b, c], -2).reshape(-1, 3, 3),
                           np.stack([a, c, d], -2).reshape(-1, 3, 3)])
    return tris.astype(np.float32)


def crop_coords(res, size):

    lo = (res - size) // 2
    ys, xs = np.mgrid[lo:lo + size, lo:lo + size]
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)


def frame_coords(res):

    ys, xs = np.divmod(np.arange(res * res, dtype=np.int64), res)
    return np.stack([xs, ys], -1).astype(np.float32)


def camera_rays(cam_cfg, render_wh, coords, cpu, seed=0):
    """Primary rays (host numpy), made once on the CPU so both backends
    get identical inputs."""
    import jax

    from micro_raytracer_tpu.models import camera as camera_mod
    from micro_raytracer_tpu.models.compiler import compile_camera

    u = np.random.default_rng(seed).random((coords.shape[0], 2),
                                           dtype=np.float32)
    cam, coords, u = jax.device_put((compile_camera(cam_cfg), coords, u), cpu)
    f = jax.jit(camera_mod.gen_rays, static_argnums=1)
    o, d = f(cam, render_wh, coords, u)
    return np.asarray(o), np.asarray(d)


def on(device, fn, *args):
    """Run jitted ``fn`` with its arguments committed to ``device``."""
    import jax

    return jax.block_until_ready(fn(*jax.device_put(args, device)))


def median_ms(fn, *args):
    import jax

    ts = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * sorted(ts)[len(ts) // 2]


def rel_err(got, want, rtol, atol):
    """Per-element error in units of the tolerance (<= 1 passes)."""

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) / (atol + rtol * np.abs(want))


# ------------------------------------------------------------ phase 2 --
def closest_hit_check(name, scene, o, d, gpu, cpu, label, cpu_chunk=None):
    """Time the jitted dense closest-hit sweep on the card and compare it
    with the CPU backend. Returns the (R,) mask of lanes whose winner
    ties or whose t is over its tolerance."""
    import jax
    import jax.numpy as jnp

    from micro_raytracer_tpu.ops import intersect

    def hit_fn(s, o, d):
        return intersect.closest_hit(s, intersect.build_frames(s), o, d,
                                     need_exit=s.any_refract)

    f = jax.jit(hit_fn)
    g_args = jax.device_put((scene, o, d), gpu)
    compiled = f.lower(*g_args).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    ms = median_ms(compiled, *g_args)
    R, P = o.shape[0], scene.n_prims
    nbytes = float(cost.get("bytes accessed", float("nan")))
    print(f"  closest_hit {name}: R={R} P={P}: {ms:.3f} ms (median of "
          f"{TIMED_CALLS}) [{label}]; bytes accessed {nbytes:.4g} vs "
          f"R*P*4 = {R * P * 4:.4g} ({nbytes / (R * P * 4):.2f}x)",
          flush=True)
    got = jax.device_get(compiled(*g_args))

    step = cpu_chunk or R
    parts = [on(cpu, f, scene, o[i:i + step], d[i:i + step])
             for i in range(0, R, step)]
    want = jax.tree_util.tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *parts)

    hit_g, hit_c = np.asarray(got.hit), np.asarray(want.hit)
    both = hit_g & hit_c
    diff_idx = both & (np.asarray(got.idx_entry) != np.asarray(want.idx_entry))
    tie = np.zeros(R, bool)
    if diff_idx.any():
        # a winner may differ only where the two best t are within 1e-6
        # relative: evaluate both rows' t on the CPU
        rows = np.nonzero(diff_idx)[0]

        def entry_t(s, o, d):
            t, _, ok = intersect.intersect_all(s, intersect.build_frames(s),
                                               o, d)
            return jnp.where(ok, t, jnp.inf)

        t_all = np.asarray(on(cpu, jax.jit(entry_t), scene, o[rows], d[rows]))
        tg = t_all[np.arange(rows.size), np.asarray(got.idx_entry)[rows]]
        tc = t_all[np.arange(rows.size), np.asarray(want.idx_entry)[rows]]
        gap = np.abs(tg - tc) / np.maximum(np.abs(tc), 1e-30)
        report(f"{name} winner rows differing (max t gap, relative)",
               float(gap.max()), 1e-6)
        tie[rows] = True
    print(f"  {name}: {int(diff_idx.sum())} of {R} winners differ "
          "(ties)", flush=True)
    report(f"{name} hit flags differing (rays)",
           int((hit_g != hit_c).sum()), 0)
    sel = both & ~tie
    err = np.zeros(R)
    err[sel] = rel_err(np.asarray(got.t_entry)[sel],
                       np.asarray(want.t_entry)[sel], 1e-5, 0.0)
    report_lanes(f"{name} t_entry error / (1e-5 |t|)", err)
    return tie | (err > 1.0)


def scatter_condition(s, frames, attrs, o, d, u):
    """Condition number 1/|n + rough*v| of each lane's scatter direction.

    The next direction is ``normalize(n + rough * v)`` with v a random unit
    vector (``rng.sphere_rand``); where v is nearly -n the sum is short and
    ulp-level differences in n and v (sin/cos differ between backends) are
    amplified by this factor. Same math as ``tracer._bounce_step`` for an
    opaque scene's entry hit.
    """
    import jax.numpy as jnp

    from micro_raytracer_tpu.ops import intersect

    hit = intersect.closest_hit(s, frames, o, d, need_exit=False)
    at = intersect.fetch_attrs(attrs, hit.idx_entry, s.n_prims)
    p = o + d * jnp.where(hit.hit, hit.t_entry, 1.0)[:, None]
    n = intersect.normal_from_attrs(at, p)
    mat = intersect.material_from_attrs(s, at, p)
    diel = (mat["metal_scalar"] == 0.0) & (mat["opacity"] != 0.0)
    rough = jnp.where(diel & (u[:, 0] < 0.8), 1.0, mat["rough"])
    ct = jnp.clip(1.0 - 2.0 * u[:, 1], -1.0, 1.0)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    phi = u[:, 2] * 2.0 * jnp.pi
    v = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    norm = jnp.linalg.norm(n + rough[:, None] * v, axis=-1)
    return 1.0 / jnp.maximum(norm, 1e-30)


def step_check(scene, o, d, tie, gpu, cpu, seed=1):
    """One fused_step_reference step at full width, card vs CPU.

    Next directions are held to their tolerance times the lane's scatter
    condition number beyond 10 (see :func:`scatter_condition`)."""
    import jax
    import jax.numpy as jnp

    from micro_raytracer_tpu.models import tracer
    from micro_raytracer_tpu.ops import intersect

    check(not scene.any_refract, "step check expects an opaque scene")
    R = o.shape[0]
    rng = np.random.default_rng(seed)
    u = rng.random((R, 7), dtype=np.float32)
    ue = rng.random(R, dtype=np.float32)

    def step(s, o, d, u, ue):
        frames = intersect.build_frames(s)
        attrs = intersect.prim_attributes(s, frames)
        ray = (o, d, jnp.ones((R,), o.dtype), jnp.ones((R,), bool))
        A = jnp.ones((R, 3), o.dtype)
        B = jnp.zeros((R, 3), o.dtype)
        ray2, A2, B2, live = tracer.fused_step_reference(
            s, frames, attrs, jnp.float32(0.85), ray, A, B, u, ue)
        return {"o": ray2[0], "d": ray2[1], "pwr": ray2[2], "A": A2,
                "B": B2, "live": live,
                "kappa": scatter_condition(s, frames, attrs, o, d, u)}

    f = jax.jit(step)
    got = jax.device_get(on(gpu, f, scene, o, d, u, ue))
    want = jax.device_get(on(cpu, f, scene, o, d, u, ue))
    keep = ~tie
    print(f"  step: {int(tie.sum())} lanes left out (winner ties, t over "
          "tolerance)", flush=True)
    report("step live flags differing (lanes)",
           int((got["live"] != want["live"])[keep].sum()), 0)
    cond = np.maximum(1.0, want["kappa"][keep] / 10.0)
    print(f"  step: {int((cond > 1).sum())} lanes with scatter condition "
          f"number > 10 (max {float(want['kappa'][keep].max()):.4g})",
          flush=True)
    for k in ("o", "d", "pwr", "A", "B"):
        err = rel_err(got[k][keep], want[k][keep], 1e-4, 1e-5)
        err = err.reshape(err.shape[0], -1).max(axis=1)
        if k == "d":
            err = err / cond
            k = "d (scaled by condition / 10 where > 10)"
        report_lanes(f"step {k} |err| / (1e-5 + 1e-4 |ref|)", err)


def radiance_check(cfg, gpu, cpu, seed=7):
    """Full-depth radiance of a centre crop, same threefry seed, card vs
    CPU, compared after tonemapping to u8."""
    import jax
    import jax.numpy as jnp

    from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
    from micro_raytracer_tpu.models.tracer import trace_radiance
    from micro_raytracer_tpu.ops import tonemap

    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    wh, bounce = cfg.frame.render_res, cfg.rt.bounce
    coords = crop_coords(RES, CROP)

    def render(s, c, coords, key):
        def body(i, acc):
            return acc + trace_radiance(s, c, wh, bounce, jnp.float32(
                cfg.rt.loss), coords, jax.random.fold_in(key, i))
        return jax.lax.fori_loop(0, CROP_SAMPLES, body,
                                 jnp.zeros((coords.shape[0], 3), jnp.float32))

    f = jax.jit(render)
    key_data = jax.random.key_data(jax.random.key(seed, impl="threefry2x32"))

    def run(dev):
        k = jax.random.wrap_key_data(jax.device_put(key_data, dev),
                                     impl="threefry2x32")
        acc = on(dev, lambda *a: f(*a, k), scene, cam, coords)
        return np.asarray(acc)

    imgs = []
    for acc in (run(gpu), run(cpu)):
        frame = jax.device_put(acc.reshape(CROP, CROP, 3), cpu)
        imgs.append(np.asarray(tonemap.finalize(
            frame, np.float32(CROP_SAMPLES), np.float32(cfg.frame.cam.gamma),
            np.float32(cfg.frame.cam.exp), (CROP, CROP))).astype(np.int32))
    diff = np.abs(imgs[0] - imgs[1])
    check(imgs[1].mean() > 1, "radiance crop rendered black")
    print(f"  radiance crop: {100 * float((diff <= 8).mean()):.2f}% of u8 "
          "values within 8", flush=True)
    report("radiance crop u8 mean |diff|", float(diff.mean()), 2.0)


def phase_kernels(gpu, cpu, label):
    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import compile_scene

    cfg = schema.RenderConfig.from_json(load_example("CornellBox"))
    cfg.frame.res, cfg.frame.ssaa = (RES, RES), 1.0
    o, d = camera_rays(cfg.frame.cam, (RES, RES), frame_coords(RES), cpu)
    scene = compile_scene(cfg.scene)
    tie = closest_hit_check("CornellBox", scene, o, d, gpu, cpu, label)
    mesh_scene = compile_scene(schema.SceneConfig.from_json({"renderer": [
        {"type": "mesh", "mesh": torus_mesh(*MESH_TRIS).tolist(),
         "pos": [0.0, 0.1, -0.1], "dir": [0.0, 0.2, 1.0, 0.6]},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.5]}]}))
    closest_hit_check(f"mesh ({MESH_TRIS[0] * MESH_TRIS[1] * 2} triangles)",
                      mesh_scene, o, d, gpu, cpu, label, cpu_chunk=1 << 16)
    step_check(scene, o, d, tie, gpu, cpu)
    radiance_check(cfg, gpu, cpu)


# ------------------------------------------------------------ phase 3 --
def light_panel_rows(res):
    """Pixel box (rows, cols) that only the CornellBox ceiling panel fills."""
    return slice(int(0.13 * res), int(0.18 * res)), \
        slice(int(0.45 * res), int(0.55 * res))


def phase_cli(out_dir):

    from micro_raytracer_tpu.frontends import cli
    from micro_raytracer_tpu.utils import codecs
    from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR

    png = os.path.join(out_dir, "cornellbox_1080.png")
    rc = cli.main([os.path.join(EXAMPLES_DIR, "CornellBox.json"),
                   "--res", str(RES), str(RES), "--sample", str(CLI_SAMPLES),
                   "-o", png])
    check(rc == 0, f"cli.main exited {rc}")
    with open(png, "rb") as f:
        img = codecs.decode_png(f.read())
    check(img.shape == (RES, RES, 3), f"PNG shape {img.shape}")
    print(f"  PNG {img.shape}, mean {img.mean():.2f}", flush=True)
    check(img.mean() > 10, "render is black")
    rows, cols = light_panel_rows(RES)
    panel = float(np.median(img[rows, cols]))
    report("ceiling light panel: 255 - median u8", 255.0 - panel, 0.0)


# ------------------------------------------------------------ phase 4 --
def http_post(port, body: bytes, timeout=600):
    """POST a render JSON; returns (status line, headers dict, body)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.sendall(b"POST /render HTTP/1.1\r\nContent-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    raw = b""
    while True:
        chunk = s.recv(1 << 20)
        if not chunk:
            break
        raw += chunk
    s.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(l.split(": ", 1) for l in lines[1:] if ": " in l)
    n = int(headers.get("Content-Length", len(rest)))
    return lines[0], headers, rest[:n]


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_http(label):
    from micro_raytracer_tpu.frontends.http import HttpServer
    from micro_raytracer_tpu.utils import codecs

    srv = HttpServer(f"127.0.0.1:{free_port()}")
    th = threading.Thread(target=srv.start, daemon=True)
    th.start()
    for _ in range(100):  # wait for the listener
        try:
            socket.create_connection(("127.0.0.1", srv.port), 1).close()
            break
        except OSError:
            time.sleep(0.1)
    default = load_example("Default")
    cornell = load_example("CornellBox")
    cornell["rt"]["sample"] = 16
    cornell["frame"]["res"] = [RES, RES]
    try:
        print(f"  transport: {srv.transport}", flush=True)
        for name, req in (("Default", default), ("CornellBox", cornell),
                          ("Default again", default)):
            t0 = time.perf_counter()
            status, headers, body = http_post(srv.port, json.dumps(req).encode())
            dt = time.perf_counter() - t0
            check(status == "HTTP/1.1 200 OK", f"{name}: {status}")
            check(headers.get("Content-Type") == "image/jpeg",
                  f"{name}: Content-Type {headers.get('Content-Type')}")
            check(body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9",
                  f"{name}: JPEG SOI/EOI markers missing")
            want = tuple(req["frame"]["res"])
            got = codecs.jpeg_size(body)
            check(got == want, f"{name}: SOF0 size {got} != {want}")
            print(f"  POST {name} {want[0]}x{want[1]}: 200 image/jpeg, "
                  f"{len(body)} bytes, {dt:.2f} s [{label}]", flush=True)
    finally:
        srv.stop()
        th.join(timeout=30)


# ------------------------------------------------------------ phase 5 --
def phase_fit(gpu, cpu, label):
    import jax
    import jax.numpy as jnp

    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
    from micro_raytracer_tpu.models.tracer import trace_radiance
    from micro_raytracer_tpu.ops import rng
    from micro_raytracer_tpu.parallel import shard
    from micro_raytracer_tpu.parallel.mesh import make_mesh

    cfg = schema.RenderConfig.from_json(load_example("CornellBox"))
    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    wh, bounce = (RES, RES), cfg.rt.bounce
    lr = 1e-2
    mesh = make_mesh(1, sp=1)
    step = shard.make_train_step(mesh, wh, bounce, lr=lr)
    params, _ = shard.split_params(scene)
    coords = jnp.asarray(frame_coords(RES))
    target = jnp.zeros((RES * RES, 3), jnp.float32)
    loss_cfg = jnp.float32(cfg.rt.loss)
    key = rng.make_key(0)
    t0 = time.perf_counter()
    compiled = step.lower(params, scene, cam, loss_cfg, coords, target,
                          key).compile()
    print(f"  fit step compile: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  memory_analysis: {compiled.memory_analysis()}", flush=True)
    for i in range(3):
        t0 = time.perf_counter()
        loss, new = compiled(params, scene, cam, loss_cfg, coords, target,
                             jax.random.fold_in(key, i))
        loss = float(loss)
        dt = time.perf_counter() - t0
        grads = {k: (np.asarray(params[k]) - np.asarray(new[k])) / lr
                 for k in params}
        check(np.isfinite(loss), f"step {i}: loss {loss}")
        for k, g in grads.items():
            check(np.all(np.isfinite(g)), f"step {i}: non-finite grad {k}")
        norm = sum(float(np.abs(g).sum()) for g in grads.values())
        check(norm > 0, f"step {i}: every gradient is zero")
        nonzero = sorted(k for k, g in grads.items() if np.abs(g).sum() > 0)
        print(f"  step {i}: loss {loss:.6g}, sum |grad| {norm:.4g}, "
              f"{dt:.3f} s [{label}]; non-zero leaves: {', '.join(nonzero)}",
              flush=True)
        params = new
    stats = gpu.memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        print(f"  peak_bytes_in_use: {stats['peak_bytes_in_use']}",
              flush=True)

    # the fit step's gradients on a crop, card vs CPU (same threefry key)
    crop = crop_coords(RES, GRAD_CROP)
    tgt = np.zeros((crop.shape[0], 3), np.float32)

    def loss_fn(p, s, c, coords, tgt, key):
        rad = trace_radiance(shard.merge_params(s, p), c, wh, bounce,
                             loss_cfg, coords, key)
        return jnp.mean((rad - tgt) ** 2)

    g = jax.jit(jax.grad(loss_fn))
    params0, _ = shard.split_params(scene)
    key_data = jax.random.key_data(jax.random.key(3, impl="threefry2x32"))
    out = []
    for dev in (gpu, cpu):
        k = jax.random.wrap_key_data(jax.device_put(key_data, dev),
                                     impl="threefry2x32")
        out.append(jax.device_get(on(dev, lambda *a: g(*a, k), params0,
                                     scene, cam, crop, tgt)))
    worst, worst_k = 0.0, None
    for k in params0:
        want = np.asarray(out[1][k], np.float64)
        if want.size == 0:
            continue
        scale = float(np.abs(want).max())
        err = float(np.abs(np.asarray(out[0][k]) - want).max()) / max(
            scale, 1e-30) if scale else float(np.abs(out[0][k]).max())
        if err > worst:
            worst, worst_k = err, k
    report(f"crop gradients max |err| / max |grad| (worst leaf {worst_k})",
           worst, 2e-3)


# ---------------------------------------------------------- multi-card --
def phase_multi(n, out_dir, label):
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from micro_raytracer_tpu.frontends import cli
    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
    from micro_raytracer_tpu.models.tracer import trace_radiance
    from micro_raytracer_tpu.parallel import shard
    from micro_raytracer_tpu.parallel.mesh import make_mesh
    from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR

    check(len(jax.devices()) >= n, f"{len(jax.devices())} devices < {n}")
    # partition-stable streams, so the sharded render can match bit for bit
    os.environ["MRT_PRNG"] = "threefry2x32"
    argv = [os.path.join(EXAMPLES_DIR, "CornellBox.json"), "--res", str(RES),
            str(RES), "--sample", "8"]
    one = os.path.join(out_dir, "cornellbox_1card.png")
    many = os.path.join(out_dir, f"cornellbox_{n}cards.png")
    t0 = time.perf_counter()
    check(cli.main(argv + ["-o", one]) == 0, "one-card CLI render failed")
    t1 = time.perf_counter()
    check(cli.main(argv + ["-o", many, "--devices", str(n)]) == 0,
          f"{n}-card CLI render failed")
    t2 = time.perf_counter()
    with open(one, "rb") as f, open(many, "rb") as g:
        same = f.read() == g.read()
    print(f"  CLI CornellBox {RES}x{RES} 8 spp: 1 card {t1 - t0:.1f} s, "
          f"dp={n} {t2 - t1:.1f} s (compile included) [{label}]", flush=True)
    report(f"dp={n} PNG bytes differ from 1 card", 0 if same else 1, 0)

    # dp x sp render, compared with the same per-shard keys on one device
    cfg = schema.RenderConfig.from_json(load_example("CornellBox"))
    scene = compile_scene(cfg.scene)
    cam = compile_camera(cfg.frame.cam)
    wh, bounce = (RES, RES), cfg.rt.bounce
    mesh = make_mesh(n, sp=2)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    coords = jnp.asarray(crop_coords(RES, CROP))
    loss = jnp.float32(cfg.rt.loss)
    key = jax.random.PRNGKey(0)
    rad = np.asarray(shard.make_sharded_render(mesh, wh, bounce)(
        scene, cam, loss, coords, key))
    per = coords.shape[0] // dp
    one_dev = jax.jit(lambda c, k: trace_radiance(scene, cam, wh, bounce,
                                                  loss, c, k))
    ref = np.concatenate([
        sum(np.asarray(one_dev(coords[i * per:(i + 1) * per],
                               jax.random.fold_in(jax.random.fold_in(key, i),
                                                  j)))
            for j in range(sp)) / sp for i in range(dp)])
    check(ref.max() > 0, "reference render is black")
    report(f"dp={dp} x sp={sp} render max |err| / (1e-5 + 1e-4 |ref|)",
           float(rel_err(rad, ref, 1e-4, 1e-5).max()), 1.0)
    # the train step (sphere + glass-mesh scenes) against one device,
    # with the driver's dry-run tolerances (raises on a mismatch)
    __graft_entry__.dryrun_multichip(n)


# --------------------------------------------------------------- main --
def main(argv=None) -> int:
    args = parse_args(argv)
    # the comparisons need the CPU backend beside the card
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's first device is {dev.platform!r}, not a "
              "GPU; nothing run", file=sys.stderr)
        return 2
    label = card_label()
    print(label, flush=True)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
          f"; devices {len(jax.devices())} x {dev.device_kind}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    cpu = jax.devices("cpu")[0]

    if args.devices > 1:
        with phase(f"multi-card ({args.devices})", label):
            phase_multi(args.devices, args.out, label)
    else:
        with phase("kernels", label):
            phase_kernels(dev, cpu, label)
        with phase("cli render", label):
            phase_cli(args.out)
        with phase("http", label):
            phase_http(label)
        with phase("fit step", label):
            phase_fit(dev, cpu, label)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
