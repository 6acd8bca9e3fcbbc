"""chip_smoke.py: refuses to report without a GPU, and its phases run
end to end at a tiny size on the CPU backend (the device programs run
through XLA's CPU compiler; no device numbers are taken here)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from libjxl_tpu.api import tpu_codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_the_cpu_backend():
    out = _run(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "not 'gpu'" in out.stdout


def test_fails_without_the_repo(tmp_path):
    """Alone in a directory the script stops at the missing package,
    before it asks JAX for a backend."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "No module named 'libjxl_tpu'" in out.stderr
    assert "not 'gpu'" not in out.stdout


@pytest.fixture
def device_routing(monkeypatch):
    """Send the public entry points down their device paths on CPU."""
    monkeypatch.setattr(tpu_codec, "accelerator_available", lambda: True)
    monkeypatch.setenv("LIBJXL_TPU_DEVICE_MIN_PIXELS", "0")


def test_one_card_phases_at_tiny_size(device_routing):
    times = chip_smoke.run_one_card(n=128, count=3, ba_n=64)
    for key in ("a_cold_s", "b_warm_s", "c_e7_warm_s", "d_warm_s",
                "gate_1024"):
        assert key in times, key


def test_four_card_paths_on_virtual_devices(device_routing):
    chip_smoke.run_four(jax.devices()[:4], big_mp=0.5, n_batch=4,
                        batch_n=256)
