"""Test harness: a virtual 8-device CPU mesh, and the ``chip`` marker.

The tier-1 command sets ``JAX_PLATFORMS=cpu``; multi-device behavior is
validated on ``xla_force_host_platform_device_count`` CPU devices, and the
Pallas tile kernel runs in interpret mode there (``interpret=True``).
Tests marked ``chip`` need a GPU: they take the ``gpu`` fixture, which
skips them anywhere else.  Run them on the card in one process:
``python -m pytest tests/ -m chip -p no:cacheprovider`` (no ``-n``).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from spada_tpu.io.mtx import load_mtx  # noqa: E402
from spada_tpu.io.workloads import GemmWorkload  # noqa: E402

CARI = os.path.join(os.path.dirname(__file__), "..", "matrices", "cari.mtx")


@pytest.fixture(scope="session")
def cari():
    return load_mtx(CARI)


@pytest.fixture(scope="session")
def cari_workload(cari):
    return GemmWorkload.from_matrix("cari", cari)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card: pytest -m chip)")
    return jax.devices()[0]
