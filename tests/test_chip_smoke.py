"""chip_smoke.py off the card: it refuses to run, and its options parse."""

import os
import subprocess
import sys

import pytest

from micro_raytracer_tpu.utils.paths import REPO_ROOT

sys.path.insert(0, REPO_ROOT)
import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    r = subprocess.run([sys.executable, os.path.join(REPO_ROOT,
                                                     "chip_smoke.py"),
                        "--out", str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout  # no result line
    assert "not a GPU" in r.stderr


@pytest.mark.parametrize("argv,devices", [([], 1), (["--devices", "4"], 4),
                                          (["--devices", "2"], 2)])
def test_devices_option(argv, devices):
    assert chip_smoke.parse_args(argv).devices == devices


@pytest.mark.parametrize("argv", [["--devices", "0"], ["--devices", "3"]])
def test_devices_option_rejects(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


def test_lane_report_budget():
    import numpy as np

    err = np.zeros(200_000)
    err[:2] = [1.5, 9.0]                 # two lanes over, within the cap
    chip_smoke.report_lanes("two outliers", err)
    err[2] = 11.0                        # one lane past the cap
    with pytest.raises(AssertionError):
        chip_smoke.report_lanes("past the cap", err)
    err = np.full(200_000, 0.5)
    err[:3] = 2.0                        # more lanes over than allowed
    with pytest.raises(AssertionError):
        chip_smoke.report_lanes("too many", err)


def test_torus_mesh_size():
    tris = chip_smoke.torus_mesh(25, 20)
    assert tris.shape == (1000, 3, 3)
