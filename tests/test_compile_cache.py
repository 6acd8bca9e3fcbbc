"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
else one fixed directory inside the checkout, also when jax was
imported before the package. Each case runs in a fresh interpreter."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = {
    "package_first": "import libjxl_tpu, jax",
    "jax_first": "import jax; import libjxl_tpu",
}


def _cache_dir(order, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = PROBE[order] + "; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("order", sorted(PROBE))
def test_default_is_fixed_path_in_checkout(order):
    assert _cache_dir(order, None) == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("order", sorted(PROBE))
def test_env_var_wins(order, tmp_path):
    assert _cache_dir(order, str(tmp_path)) == str(tmp_path)
