"""Profiling hooks: the renderer's observability layer.

The reference's only perf instrumentation is a per-sample wall-clock log
(reference src/sampler.rs:35,77; cli.rs:164). Here that becomes
per-pass rays/s counters (renderer/CLI logs) plus an opt-in XLA device
trace capturable with :func:`device_trace` and viewable in TensorBoard's
profile plugin or parsed from the ``*.trace.json.gz`` perfetto export.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Capture a JAX device trace for the enclosed block.

    Enabled when ``logdir`` is given or ``MRT_TRACE_DIR`` is set; otherwise
    a no-op, so call sites can wrap hot loops unconditionally.
    """
    logdir = logdir or os.environ.get("MRT_TRACE_DIR")
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def rays_per_second(n_pixels: int, n_samples: int, seconds: float) -> float:
    """Primary paths per second (the reference's unit of work)."""
    return n_pixels * n_samples / max(seconds, 1e-9)
