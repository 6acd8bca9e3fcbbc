"""Test configuration: the suite runs on an 8-device virtual CPU mesh.

Sharding tests need several devices; XLA's host platform provides them
as virtual devices (--xla_force_host_platform_device_count), so the
mesh code is checked here against single-device references. Must run
before the first jax import.

Tests that need a GPU carry the `gpu` marker and skip on the CPU mesh;
`python chip_smoke.py` runs them on the card (it selects the GPU
platform before pytest imports this file).
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips on the CPU test mesh")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is "
                    f"{jax.default_backend()!r})")
