"""Multi-host initialization for multi-process rendering.

Single-program multi-host JAX: every host runs the same render script,
``initialize()`` wires them into one runtime, and the existing
``shard_map`` paths in
:mod:`micro_raytracer_tpu.parallel.shard` then span all hosts' devices.
Host 0 gathers the final framebuffer (the reference's mutex merge,
sampler.rs:60-70, reborn as an all-gather).
"""

from __future__ import annotations

import os

import jax


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Idempotently initialize ``jax.distributed`` when running multi-host.

    No-ops when single-process (the common case and all CI). Arguments
    default to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); nothing is discovered
    from the environment beyond them.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    n = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    if not coordinator or n <= 1:
        return
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=n, process_id=pid)


def is_primary() -> bool:
    """True on the host that should write images / logs."""
    return jax.process_index() == 0


def local_slice(n_total: int):
    """This process's contiguous shard bounds of a length-``n_total`` axis."""
    per = -(-n_total // jax.process_count())
    start = jax.process_index() * per
    return start, min(start + per, n_total)
