"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip shardings are validated on forced host devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8) per SURVEY.md sec 4.
Tests marked `gpu` need a CUDA device: they skip elsewhere and run on the
card through `python chip_smoke.py`.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; runs on the card via chip_smoke.py")
