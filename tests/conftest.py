"""Test configuration: run on a virtual 8-device CPU mesh in float64.

Multi-device sharding tests use ``xla_force_host_platform_device_count=8``;
parity tests against the reference's hand-computed doubles need x64. Env
vars MUST be set before jax is imported anywhere, hence this top-level
conftest.

Tests marked ``gpu`` need the card and skip elsewhere (the ``gpu``
fixture decides). On a machine with a GPU, run them with
``TPUNAV_GPU_TESTS=1 python -m pytest tests -m gpu``, which keeps JAX's
default platform instead of the CPU.
"""

import os

import pytest

_ON_GPU = bool(os.environ.get("TPUNAV_GPU_TESTS"))
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (TPUNAV_GPU_TESTS=1 on a machine with "
                    "one)")
    return dev
