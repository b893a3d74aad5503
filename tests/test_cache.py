"""Where the persistent compile cache lives."""

import os
import subprocess
import sys

from micro_raytracer_tpu.utils.paths import REPO_ROOT

_PROBE = (
    "import jax\n"
    "from micro_raytracer_tpu.utils import cache\n"
    "cache.enable_compile_cache()\n"
    "print(cache.cache_dir())\n"
    "print(jax.config.jax_compilation_cache_dir)\n")


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    env.pop("MRT_NO_COMPILE_CACHE", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out


def test_cache_defaults_to_checkout_dir():
    want = os.path.join(REPO_ROOT, ".jax_cache")
    assert _probe(None) == [want, want]
    assert os.path.isdir(want)


def test_cache_follows_env_var(tmp_path):
    d = str(tmp_path / "xla")
    assert _probe(d) == [d, d]
