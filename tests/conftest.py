"""Test configuration: the CPU with a virtual 8-device mesh by default.

The platform is fixed through ``jax.config`` before any backend
initializes. ``ANY4_TEST_GPU=1`` leaves JAX on its default backend instead,
so that the tests marked ``chip`` run on an NVIDIA GPU:

    ANY4_TEST_GPU=1 python -m pytest tests -m chip

Whether a GPU is present is decided at run time by the ``_chip_only``
fixture, never while a module is imported.
"""
import os

import pytest

ON_GPU = os.environ.get("ANY4_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", False)

assert ON_GPU or jax.default_backend() == "cpu", (
    "tests must run on CPU; another backend was already initialized before "
    "conftest could override the platform")


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip a ``chip``-marked test unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("chip") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (ANY4_TEST_GPU=1 on the card)")
