# Give the main pytest process 8 virtual CPU devices (before jax import) so
# tests exercising sharding have a mesh to build; launch/dryrun.py still
# forces its own 512 placeholder devices in a separate process.
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def tc_oracle(adj: np.ndarray) -> np.ndarray:
    """Exact transitive closure by boolean matrix fixpoint."""
    r = adj.copy()
    while True:
        r2 = r | (r @ adj)
        if (r2 == r).all():
            return r
        r = r2


def random_edges(rng, n: int, m: int) -> np.ndarray:
    e = np.unique(rng.integers(0, n, size=(m, 2)), axis=0).astype(np.int32)
    return e


def adj_of(edges: np.ndarray, n: int) -> np.ndarray:
    a = np.zeros((n, n), bool)
    a[edges[:, 0], edges[:, 1]] = True
    return a


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test skips itself where "
        "torch.cuda.is_available() is false",
    )
