"""Test harness: run everything on a virtual 8-device CPU mesh.

Sharding/collective tests need multiple devices; the card is exercised by
the ``gpu``-marked tests (run on a machine with one:
``python -m pytest tests -m gpu``), ``chip_smoke.py`` and ``bench.py``.
Env vars must be set before the first jax import; ``JAX_PLATFORMS=cpu``
also selects interpret mode for the Pallas kernels.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from gsplat_jax.utils.platform import enable_compile_cache  # noqa: E402

# Persistent compile cache: interpret-mode Pallas compiles dominate suite
# wall-clock; cache hits across pytest runs cut repeat suite time.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (deep redundancy checks)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: deep/redundant check, skipped unless --runslow"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA card")
