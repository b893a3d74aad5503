"""Multi-process ``jax.distributed`` check (CPU backend, real processes).

The reference scales with an in-process thread pool (sampler.rs:28-78); this
framework's multi-host story is SPMD: every host runs the same script,
``parallel.distributed.initialize`` wires them into one runtime, pixel
shards render per-process, and host 0 gathers the frame. This tool actually
exercises that path locally: it spawns N worker processes (re-invoking this
file), each of which

  1. initializes ``jax.distributed`` against a local coordinator,
  2. asserts the global device view (process_count, devices),
  3. renders its disjoint pixel shard (``distributed.local_slice``),
  4. all-gathers the frame across processes with a real collective
     (``multihost_utils.process_allgather``),

and the parent then re-renders every shard single-process and asserts the
gathered frames match on every worker.

The parent and every worker run on the CPU backend, never on an
accelerator: several processes must not share one card (each JAX process
reserves most of its memory), and the check is about the multi-process
plumbing, not device speed.

Usage: python tools/distributed_check.py [--procs 2]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCENE = {
    "renderer": [
        {"type": "sphere", "r": 0.5, "mat": {"rough": 1.0}},
        {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.5],
         "mat": {"albedo": [0.6, 0.7, 0.8], "rough": 1.0}},
    ],
    "light": [{"type": "point", "pos": [-0.5, -1, 0.5], "pwr": 0.5}],
    "sky": {"color": [0.1, 0.1, 0.2], "pwr": 0.5},
}
N_PIX = 256
BOUNCE = 2


def _render_shard(pid: int, lo: int, hi: int):
    """One process's pixel shard; keys are per-shard so every process (and
    the single-process reference) draws identical streams."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.compiler import compile_camera, compile_scene
    from micro_raytracer_tpu.models.tracer import trace_radiance

    scene = compile_scene(schema.SceneConfig.from_json(SCENE))
    cam = compile_camera(schema.CameraConfig.from_json({}))
    ys, xs = np.divmod(np.arange(N_PIX, dtype=np.int64), 16)
    coords = jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))[lo:hi]
    key = jax.random.fold_in(jax.random.PRNGKey(7), pid)
    return np.asarray(trace_radiance(scene, cam, (16, 16), BOUNCE,
                                     jnp.float32(0.15), coords, key))


def worker(pid: int, n: int, port: int, outdir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from micro_raytracer_tpu.parallel import distributed

    distributed.initialize(coordinator=f"127.0.0.1:{port}",
                           num_processes=n, process_id=pid)
    import numpy as np

    assert jax.process_count() == n, jax.process_count()
    assert jax.process_index() == pid
    assert len(jax.devices()) == n * jax.local_device_count(), jax.devices()
    assert distributed.is_primary() == (pid == 0)

    lo, hi = distributed.local_slice(N_PIX)
    rad = _render_shard(pid, lo, hi)

    # a REAL cross-process collective: tiled all-gather of the shards
    from jax.experimental import multihost_utils

    gathered = np.asarray(multihost_utils.process_allgather(rad, tiled=True))
    assert gathered.shape == (N_PIX, 3), gathered.shape
    np.save(os.path.join(outdir, f"gathered{pid}.npy"), gathered)
    np.save(os.path.join(outdir, f"shard{pid}.npy"), rad)
    print(f"worker {pid}/{n}: ok devices={len(jax.devices())}")


def main(n_procs: int = 2) -> int:
    import jax
    import numpy as np

    # the parent's reference renders stay off the accelerator too
    jax.config.update("jax_platforms", "cpu")

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    outdir = tempfile.mkdtemp(prefix="mrt_dist_")
    env = dict(os.environ)
    # CPU-only workers (one CPU device each: no forced device counts)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             json.dumps({"pid": i, "n": n_procs, "port": port,
                         "outdir": outdir})],
            env=env)
        for i in range(n_procs)
    ]
    rcs = [p.wait(timeout=300) for p in procs]
    if any(rcs):
        print(f"FAIL: worker exit codes {rcs}")
        return 1

    # single-process reference for every shard
    per = -(-N_PIX // n_procs)
    ref = np.concatenate([
        _render_shard(pid, pid * per, min((pid + 1) * per, N_PIX))
        for pid in range(n_procs)])
    for pid in range(n_procs):
        shard = np.load(os.path.join(outdir, f"shard{pid}.npy"))
        np.testing.assert_allclose(
            shard, ref[pid * per:min((pid + 1) * per, N_PIX)],
            rtol=1e-5, atol=1e-6, err_msg=f"shard {pid}")
        gathered = np.load(os.path.join(outdir, f"gathered{pid}.npy"))
        np.testing.assert_allclose(gathered, ref, rtol=1e-5, atol=1e-6,
                                   err_msg=f"gathered frame on worker {pid}")
    print(f"distributed_check OK: {n_procs} processes, frame ({N_PIX},3) "
          "gathered identically on every worker")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--procs", type=int, default=2)
    a = ap.parse_args()
    if a.worker:
        w = json.loads(a.worker)
        worker(w["pid"], w["n"], w["port"], w["outdir"])
        sys.exit(0)
    sys.exit(main(a.procs))
