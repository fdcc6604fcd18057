"""The port on the card: CUDA kernels against their plain versions and the
engine on CUDA against the engine on the CPU, bit for bit.

Imports neither JAX nor ``repro``, so it runs on a machine that has only
PyTorch with CUDA::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips itself where ``torch.cuda.is_available()`` is false.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.datalog_workloads import ALL
from repro_torch.core import Engine, EngineConfig
from repro_torch.data.graphs import random_graph
from repro_torch.kernels import bitmm as kb
from repro_torch.kernels.ref import bitmm_fused_delta_plain, bitmm_plain, pack_bits

pytestmark = pytest.mark.cuda

SHAPES = [(128, 128, 128), (130, 70, 200), (64, 33, 97), (1, 1, 1), (300, 1000, 4100)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(cuda, shape):
    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    for density in (0.0, 0.02, 0.3, 1.0):
        a = pack_bits(torch.rand((m, k), generator=gen, device=cuda) < density)
        b = pack_bits(torch.rand((k, n), generator=gen, device=cuda) < density)
        cur = pack_bits(torch.rand((m, n), generator=gen, device=cuda) < 0.05)
        before = (kb.bitmm.launches, kb.bitmm_fused_delta.launches)
        assert torch.equal(kb.bitmm(a, b), bitmm_plain(a, b))
        for got, want in zip(kb.bitmm_fused_delta(a, b, cur), bitmm_fused_delta_plain(a, b, cur)):
            assert torch.equal(got, want)
        assert (kb.bitmm.launches, kb.bitmm_fused_delta.launches) == (
            before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["tc", "sg", "cspa", "sssp"])
def test_engine_on_cuda_matches_cpu(cuda, name):
    edges = random_graph(60, 200, seed=4, weights=name == "sssp")
    edb = {"arc": edges}
    if name == "sssp":
        edb["id"] = np.array([[int(edges[0, 0])]], np.int32)
    if name == "cspa":
        edb = {"assign": edges[:120], "dereference": edges[120:]}
    outs = [Engine(EngineConfig(), device=d).run(ALL[name].program, edb) for d in (cuda, "cpu")]
    assert outs[0].keys() == outs[1].keys()
    for rel in outs[0]:
        np.testing.assert_array_equal(outs[0][rel], outs[1][rel])
