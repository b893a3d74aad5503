"""Test harness: run on an 8-device virtual CPU mesh.

Tests exercise sharding and the tracer on the CPU so they run anywhere.
The GPU path is covered by ``chip_smoke.py`` and by the tests marked
``gpu``, which skip (from the ``gpu_device`` fixture) when no card is
present. Run those on the card with ``pytest -m gpu tests/``.
"""

import os

# Unless the caller asks for the card (MRT_TEST_GPU=1, for `-m gpu` runs),
# tests run on the CPU with 8 virtual devices for the sharding tests.
if os.environ.get("MRT_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when none is present."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("no GPU present (run with MRT_TEST_GPU=1 on the card)")
    return devs[0]
