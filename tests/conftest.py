"""Test configuration: the CPU with a virtual 8-device mesh by default.

Sharding tests use ``--xla_force_host_platform_device_count=8``. Tests
marked ``gpu`` need an NVIDIA card: they skip unless the run selects one
(``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1337)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py covers it on the card)")
