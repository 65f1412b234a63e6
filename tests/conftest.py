"""Test configuration: the XLA CPU backend with 8 virtual devices, so the
sharding tests run without cards (SURVEY.md §4), unless JAX_PLATFORMS
names another platform. chip_smoke.py runs the `gpu`-marked tests on the
card with JAX_PLATFORMS=cuda; here they skip (the `gpu` fixture decides).
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; run on the card by chip_smoke.py")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs it on the card")
