"""Test config: the CPU backend with a virtual 8-device mesh, and the
on-chip marker.

Mirrors the reference's strategy of exercising the full design in a
simulated environment (Chisel C++ emulator + 64 MB memory model,
``chisel/Main.scala:73-83``): the executors run on the CPU backend
(``JAX_PLATFORMS=cpu``), and sharding tests get 8 virtual devices.
Tests marked ``on_chip`` need an NVIDIA GPU; the ``gpu`` fixture decides
at run time, and skips them elsewhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # only the CPU backend reads this; it must be set before JAX starts
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from spmv_vector_cache_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REFERENCE_MATRICES = "/root/reference/matrices"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_MATRICES)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The GPU device for ``on_chip`` tests; skips where there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    return jax.devices()[0]


def random_csr(rng, rows, cols, density=0.05, dtype=np.float32):
    """Random CSR with sorted indices for property tests."""
    from scipy import sparse

    a = sparse.random(rows, cols, density=density, format="csr",
                      random_state=np.random.RandomState(int(rng.integers(1 << 30))),
                      dtype=np.float64).astype(dtype)
    a.sort_indices()
    from spmv_vector_cache_tpu.formats.convert import from_scipy
    return from_scipy(a)
