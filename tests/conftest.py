import os
import sys

import pytest

# The suite runs on XLA:CPU with 8 virtual devices (the --mesh paths need
# several).  Card-only tests carry the `gpu` marker and skip here; on a GPU
# machine run them with PANMAP_TESTS_ON_DEVICE=1, which leaves the platform
# to JAX.  The CPU pin is applied to the config before any backend starts.
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")  # see panmap_tpu.__init__
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
if not os.environ.get("PANMAP_TESTS_ON_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` run only where JAX's first device is a GPU; the
    decision is made here, per test, never at import or collection time."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
