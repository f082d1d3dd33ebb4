"""Test configuration: force an 8-device virtual CPU mesh.

All tests run on CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices so that
multi-device sharding paths (``parallel/``) execute and are validated
without a card, per the reference's own strategy of testing multi-board
behavior with protocol-level fakes (SURVEY.md section 4). Pallas kernels run
in interpret mode here.

Tests marked ``gpu`` need the card and skip elsewhere; the decision is
made inside a fixture, never at import or collection time, so every
pytest-xdist worker collects the same tests. On a machine with a GPU run
them with ``python -m pytest tests/ -m gpu -p no:xdist`` after removing
the CPU override below (``SHTPU_TEST_GPU=1``).
"""

import os

if os.environ.get("SHTPU_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's device is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs a GPU; JAX platform is {platform!r}")


@pytest.fixture(scope="session")
def stereo_pair_small():
    """The seeded 640x480 boot pair (utils/fixtures.py), exact gray."""
    from steroscopic_hardware_tpu.utils.fixtures import VGA, stereo_pair

    left, right, _ = stereo_pair(VGA, seed=0)
    return left, right


@pytest.fixture(scope="session")
def stereo_pair_hd():
    """The seeded 1920x1080 pair (the reference's VITA-2000 capture)."""
    from steroscopic_hardware_tpu.utils.fixtures import FULL_HD, stereo_pair

    left, right, _ = stereo_pair(FULL_HD, seed=0)
    return left, right


# function-scoped: every test gets the same fresh deterministic stream,
# so adding/removing/reordering tests can never change another test's
# random draws (session scope made thresholds order-dependent)
@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
