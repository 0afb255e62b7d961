"""SPMD test harness: 8 virtual CPU devices + Pallas TPU interpret mode.

The reference tests only on real multi-GPU under torchrun (SURVEY.md §4);
here the same SPMD tests run on any host by simulating an 8-device mesh
on CPU, with Pallas TPU interpret mode providing faithful semantics for
remote DMA and semaphores.
"""

import os

# Must happen before the JAX backend is initialised.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-process/subprocess tests excluded from the "
        "tier-1 `-m 'not slow'` sweep (covered by the NET_SMOKE "
        "gate instead)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch/CUDA port's kernels); "
        "skips without one")


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs


@pytest.fixture(scope="session")
def tp8_mesh(devices):
    return Mesh(np.array(devices), ("tp",))


@pytest.fixture(scope="session")
def tp4_mesh(devices):
    return Mesh(np.array(devices[:4]), ("tp",))


@pytest.fixture(scope="session")
def ep4_mesh(devices):
    return Mesh(np.array(devices[:4]), ("ep",))


@pytest.fixture(scope="session")
def sp4_mesh(devices):
    return Mesh(np.array(devices[:4]), ("sp",))


@pytest.fixture(scope="session")
def dp2_tp4_mesh(devices):
    return Mesh(np.array(devices).reshape(2, 4), ("dp", "tp"))


@pytest.fixture(scope="session")
def dcn2_ici4_mesh(devices):
    """Two-level mesh: axis "dcn" plays the inter-slice fabric, "ici"
    the intra-slice torus (hierarchical collective tests)."""
    return Mesh(np.array(devices).reshape(2, 4), ("dcn", "ici"))
