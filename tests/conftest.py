"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices: distributed
and sharding code is tested the standard JAX way (SURVEY.md §4), a single
process with a virtual device mesh. A platform already named in
``JAX_PLATFORMS`` is kept, so ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/`` runs the GPU-only tests on a card.

Tests marked ``gpu`` skip unless JAX's first device is a GPU; the fixture
below decides when each test runs, never at import.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

from vitax.utils import enable_compilation_cache  # noqa: E402

# persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else
# <repo>/.jax_cache): repeat suite runs skip most XLA compiles
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
