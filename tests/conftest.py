"""Test configuration: CPU with an 8-device virtual mesh.

The tests run on the CPU (fast for tiny shapes; the virtual mesh stands
in for multi-device paths), with the persistent compilation cache on —
compiles dominate test time.  Tests that need a GPU carry the ``gpu``
marker and skip elsewhere (``gpu_device`` fixture); ``chip_smoke.py``
runs them on the card.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import pytest  # noqa: E402

from llicti_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

if os.environ.get("LLICTI_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")
enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card via chip_smoke.py)")
    return jax.devices()[0]
