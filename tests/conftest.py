"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

Device-path tests check sharding and multi-device logic on CPU. Tests
marked `chip` need a GPU and skip without one; on a GPU machine run them
with `JAX_PLATFORMS=cuda python -m pytest -m chip tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
# the reference's own test inputs, present only beside a reference checkout
REFDATA = pathlib.Path("/root/reference/testdata")


@pytest.fixture(scope="session")
def refdata():
    if not REFDATA.is_dir():
        pytest.skip("reference testdata unavailable")
    return REFDATA


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX finds none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
