"""Test configuration.

By default the tests run on the CPU, on a virtual 8-device CPU mesh with
fp64 (``JAX_PLATFORMS=cpu``; ``XLA_FLAGS`` gets
``--xla_force_host_platform_device_count=8``).

When ``JAX_PLATFORMS`` names the GPU (``JAX_PLATFORMS=cuda python -m
pytest tests -m gpu``), the platform is left alone so the tests marked
``gpu`` run on the card.  Whether a card is present is decided inside
the ``gpu`` fixture, never while a module is imported.
"""

import os

import pytest

_GPU_RUN = any(p in os.environ.get("JAX_PLATFORMS", "").lower()
               for p in ("cuda", "gpu"))

if not _GPU_RUN:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX computes on an NVIDIA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest tests -m gpu")
