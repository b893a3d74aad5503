"""Progressive frame renderer: the array equivalent of the reference Sampler.

The reference schedules dim x dim pixel-tile jobs on a CPU thread pool and
merges tiles under a mutex (reference src/sampler.rs:28-78). Here the
frame is a flat padded pixel buffer rendered in fixed-size chunks by one
jitted wavefront kernel per chunk; samples accumulate into a device-resident
f32 framebuffer (progressive rendering, cli.rs:162-170). Multi-chip sharding
lives in :mod:`micro_raytracer_tpu.parallel.shard` and reuses the same kernel.

Progressive state (accum, count, rng key) is exposed for checkpoint/resume —
the durable version of the reference's ``--update`` flag (cli.rs:166-169).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import tonemap
from .compiler import compile_camera, compile_scene
from .schema import RenderConfig
from .tracer import trace_radiance


def _part1by1(v: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of ``v`` into the even bit positions."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def morton_ray_order(nw: int, nh: int) -> np.ndarray:
    """Pixel flat indices (y*nw+x) in Morton (Z-curve) order.

    Ray slot ``i`` renders pixel ``order[i]``. Z-ordering makes every
    power-of-two run of consecutive ray slots a compact ~square pixel
    block instead of the one-row strips row-major order produces, so
    neighbouring lanes trace spatially coherent primary rays. The
    reference gets the same locality from its dim x dim tile jobs
    (sampler.rs:28-43).
    """
    ys, xs = np.divmod(np.arange(nw * nh, dtype=np.int64), nw)
    code = _part1by1(xs) | (_part1by1(ys) << np.uint64(1))
    return np.argsort(code, kind="stable").astype(np.int64)


RAY_LAYOUT = "morton1"  # bump when the ray->pixel mapping changes


def _pick_chunk(n_pix: int, scene) -> int:
    """Ray-chunk size keeping the per-sweep intermediates within a budget.

    Fewer, bigger calls amortize the per-call cost, while the sweep's
    intermediates grow with rays x rows: the matmul triangle sweep
    materializes six (R*L, Pt)-sized outputs, the Moller-Trumbore sweep
    (R*L, P, 3) tensors. The budgets and the 2^17-ray cap have not been
    re-measured on a GPU.
    """
    from ..models import schema as _schema
    from ..ops import intersect as _intersect

    L = max(1, scene.n_lights)
    P = max(1, scene.n_prims)
    n_tri = scene.kind_counts[_schema.KIND_TRIANGLE]
    if _intersect._use_tri_mxu(n_tri):
        budget, per_ray = 1 << 27, P * L * 6
    else:
        budget, per_ray = 1 << 24, P * L * 3
    c = max(1024, min(1 << 17, budget // per_ray))
    c = (c // 1024) * 1024
    return min(c, max(1024, -(-n_pix // 1024) * 1024))


@partial(jax.jit, static_argnames=("render_wh", "bounce", "n_samples"),
         donate_argnames=("accum",))
def _sample_chunk_many(scene, cam, render_wh, bounce, n_samples, loss,
                       coords, key, accum):
    """Accumulate ``n_samples`` paths per pixel of one chunk in a single call."""

    def body(i, acc):
        rad = trace_radiance(scene, cam, render_wh, bounce, loss, coords,
                             jax.random.fold_in(key, i))
        return acc + rad

    return jax.lax.fori_loop(0, n_samples, body, accum)


def _make_sp_chunk_fn(mesh, render_wh, bounce, n_samples):
    """Sharded chunk sampler: rays over ``dp``, samples over ``sp``.

    Samples become an explicit vmapped axis sharded over ``sp`` (GSPMD, not
    shard_map): partitioning then preserves the *global* counter-based RNG
    semantics, so every sample uses exactly the draws the single-device
    fori_loop would use (fold_in(key, i)) and the merged accumulator matches
    it up to summation order. The cross-sp sum is XLA's collective — the
    reference's tile-merge mutex (sampler.rs:39-74) as an all-reduce.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sp = mesh.shape["sp"]
    q = -(-n_samples // sp)
    rad_sh = NamedSharding(mesh, P("sp", "dp"))

    def fn(scene, cam, loss, coords, key, accum):
        def body(j, acc):
            idx = j * sp + jnp.arange(sp)
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
            rad = jax.vmap(lambda k: trace_radiance(
                scene, cam, render_wh, bounce, loss, coords, k))(keys)
            rad = jax.lax.with_sharding_constraint(rad, rad_sh)
            w = (idx < n_samples).astype(acc.dtype)[:, None, None]
            return acc + jnp.sum(rad * w, axis=0)

        return jax.lax.fori_loop(0, q, body, accum)

    return jax.jit(fn, donate_argnums=(5,))


class Renderer:
    """Progressive renderer over a compiled scene.

    Equivalent surface to the reference ``Sampler`` (sampler.rs:11-99):
    ``execute()`` adds one sample per pixel, ``img()`` tonemaps the running
    mean.  ``execute_many(n)`` fuses n samples into one device call.
    """

    def __init__(self, config: RenderConfig, seed: int = 0,
                 chunk: int | None = None, mesh=None):
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``dp`` axis —
        ray chunks shard across it and XLA partitions the (embarrassingly
        parallel) trace with no collectives; the accumulation framebuffer
        stays sharded until :meth:`framebuffer` gathers it."""
        from ..utils.cache import enable_compile_cache

        enable_compile_cache()
        self.config = config
        self.scene = compile_scene(config.scene)
        self.cam = compile_camera(config.frame.cam)
        self.render_wh = config.frame.render_res
        nw, nh = self.render_wh
        self.n_pix = nw * nh
        self.chunk = chunk or _pick_chunk(self.n_pix, self.scene)
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape["dp"]
            self.chunk = -(-self.chunk // dp) * dp  # divisible by dp
        n_pad = -(-self.n_pix // self.chunk) * self.chunk
        order = morton_ray_order(nw, nh)
        # padding ray slots re-render pixel 0; their accum rows are dropped
        pix = np.concatenate([order, np.zeros(n_pad - self.n_pix, np.int64)])
        ys, xs = np.divmod(pix, nw)
        coords = np.stack([xs, ys], axis=-1).astype(np.float32)
        # pixel flat index -> ray slot, for frame assembly
        inv = np.empty(self.n_pix, np.int64)
        inv[order] = np.arange(self.n_pix, dtype=np.int64)
        self._inv_order = inv
        self._coords = jnp.asarray(coords.reshape(-1, self.chunk, 2))
        self.n_chunks = self._coords.shape[0]
        self._accum = jnp.zeros((self.n_chunks, self.chunk, 3), jnp.float32)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            ray_sh = NamedSharding(mesh, PartitionSpec(None, "dp"))
            self._coords = jax.device_put(self._coords, ray_sh)
            acc_sh = NamedSharding(mesh, PartitionSpec(None, "dp"))
            self._accum = jax.device_put(self._accum, acc_sh)
        self.count = 0
        from ..ops.rng import make_key

        self.key = make_key(seed)
        self._loss = jnp.float32(config.rt.loss)
        # sample-parallel sharded samplers, one per fused n_samples
        self._sp = mesh.shape.get("sp", 1) if mesh is not None else 1
        self._sp_fns: dict = {}

    # -- sampling ----------------------------------------------------------
    def execute(self) -> float:
        """One path-tracing sample for every pixel; returns elapsed seconds."""
        return self.execute_many(1)

    def execute_many(self, n_samples: int) -> float:
        t0 = time.perf_counter()
        base = jax.random.fold_in(self.key, self.count)
        if self._sp > 1:
            if n_samples not in self._sp_fns:
                self._sp_fns[n_samples] = _make_sp_chunk_fn(
                    self.mesh, self.render_wh, self.config.rt.bounce,
                    n_samples)
            fn = self._sp_fns[n_samples]
            from jax.sharding import NamedSharding, PartitionSpec

            outs = []
            for c in range(self.n_chunks):
                k = jax.random.fold_in(base, c)
                outs.append(fn(self.scene, self.cam, self._loss,
                               self._coords[c], k, self._accum[c]))
            self._accum = jax.device_put(
                jnp.stack(outs),
                NamedSharding(self.mesh, PartitionSpec(None, "dp")))
        else:
            # one jitted call per chunk, same compiled program for every
            # chunk; the calls queue on the device and sync once below
            outs = []
            for c in range(self.n_chunks):
                k = jax.random.fold_in(base, c)
                outs.append(_sample_chunk_many(
                    self.scene, self.cam, self.render_wh,
                    self.config.rt.bounce, n_samples, self._loss,
                    self._coords[c], k, self._accum[c]))
            self._accum = jnp.stack(outs)
        jax.block_until_ready(self._accum)
        self.count += n_samples
        return time.perf_counter() - t0

    # -- image -------------------------------------------------------------
    def _device_frame(self):
        """Running radiance sum as a device-resident (nh, nw, 3) array."""
        flat = self._accum.reshape(-1, 3)
        # Morton ray order -> row-major pixels
        flat = flat[jnp.asarray(self._inv_order)]
        nw, nh = self.render_wh
        return flat.reshape(nh, nw, 3)

    def framebuffer(self) -> np.ndarray:
        """Running radiance sum as (nh, nw, 3) float32 (host copy)."""
        return np.asarray(self._device_frame())

    def img(self) -> np.ndarray:
        """Tonemapped, SSAA-downsampled (h, w, 3) uint8 image (sampler.rs:80-99).

        The finalize runs on the device; only the u8 image crosses to
        the host.
        """
        out = tonemap.finalize(self._device_frame(),
                               jnp.float32(max(self.count, 1)),
                               self.cam.gamma, self.cam.exp,
                               self.config.frame.res)
        return np.asarray(out)

    # -- checkpoint/resume ---------------------------------------------------
    def save_state(self, path: str) -> None:
        """Persist progressive render state (framebuffer, count, rng key)."""
        np.savez(path, accum=np.asarray(self._accum).reshape(-1, 3),
                 count=self.count, key=np.asarray(jax.random.key_data(self.key)),
                 key_impl=str(jax.random.key_impl(self.key)),
                 render_wh=np.asarray(self.render_wh), chunk=self.chunk,
                 layout=RAY_LAYOUT)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        saved_wh = tuple(int(v) for v in data["render_wh"]) \
            if "render_wh" in data else None
        if saved_wh is not None and saved_wh != tuple(self.render_wh):
            raise ValueError(
                f"saved state was rendered at {saved_wh}, current render "
                f"resolution is {tuple(self.render_wh)} — resume with the "
                "same --res/--ssaa settings")
        saved_layout = str(data["layout"]) if "layout" in data else "rowmajor"
        if saved_layout != RAY_LAYOUT:
            raise ValueError(
                f"saved state uses ray layout {saved_layout!r}, this build "
                f"renders in {RAY_LAYOUT!r} — the accumulator rows would map "
                "to the wrong pixels; restart the render")
        want = self.n_chunks * self.chunk
        if data["accum"].shape[0] != want:
            raise ValueError(
                f"saved state holds {data['accum'].shape[0]} accumulator rows "
                f"but the current render settings need {want} "
                f"({self.n_chunks} chunks x {self.chunk}) — state was saved "
                "with different render/chunk settings")
        accum = jnp.asarray(data["accum"]).reshape(self.n_chunks, self.chunk, 3)
        self._accum = accum
        if self.mesh is not None:  # restore device-mesh sharding
            from jax.sharding import NamedSharding, PartitionSpec

            acc_sh = NamedSharding(self.mesh, PartitionSpec(None, "dp"))
            self._accum = jax.device_put(accum, acc_sh)
        self.count = int(data["count"])
        impl = str(data.get("key_impl", "threefry2x32"))
        self.key = jax.random.wrap_key_data(jnp.asarray(data["key"]), impl=impl)


def render_image(config: RenderConfig, seed: int = 0, on_sample=None,
                 samples_per_pass: int | None = None) -> np.ndarray:
    """Render a full frame: ``rt.sample`` progressive passes then tonemap.

    ``on_sample(i, seconds, renderer)`` is invoked after each pass (the
    reference's per-sample log + ``--update`` hook, cli.rs:162-170).
    """
    r = Renderer(config, seed=seed)
    total = config.rt.sample
    # up to 64 samples fused per device call: fewer, fatter calls
    step = samples_per_pass or (1 if on_sample else min(total, 64))
    done = 0
    while done < total:
        n = min(step, total - done)
        dt = r.execute_many(n)
        done += n
        if on_sample:
            on_sample(done - 1, dt, r)
    return r.img()
