"""The port on the card: CUDA kernels against their plain versions, the
engine on CUDA against the engine on the CPU bit for bit, and the two-tower
model on CUDA against the same model on the CPU.

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
from repro_torch.configs.two_tower_retrieval import SMOKE
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.kernels import bitmm as kb
from repro_torch.kernels import gather_sum as kg
from repro_torch.kernels.ref import (
    bitmm_fused_delta_plain, bitmm_plain, gather_sum_plain, pack_bits,
)
from repro_torch.models.recsys import TwoTower

pytestmark = pytest.mark.cuda

# the kernel's tiles are 128 rows x 256 columns x 1024-bit K stages: these
# shapes are multiples of none of them, or one more than a multiple
SHAPES = [(128, 128, 128), (130, 70, 200), (64, 33, 97), (1, 1, 1), (300, 1000, 4100),
          (129, 257, 8193)]


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


def _both_match_plain(a, b, cur):
    assert torch.equal(kb.bitmm(a, b), bitmm_plain(a, b))
    for got, want in zip(kb.bitmm_fused_delta(a, b, cur), bitmm_fused_delta_plain(a, b, cur)):
        assert torch.equal(got, want)


def _mixed_density(cuda):
    """Row blocks whose 1024-bit K stages are empty, sparse and dense side by
    side, so one launch skips, walks and runs the MMA; row block 2, with no
    MMA stage, goes to the light walk kernel."""
    rows, k = 300, 4 * 1024 + 40
    density = torch.zeros((rows, k), device=cuda)
    density[:, 1024:2048] = 2e-4                  # stage 1: a few bits, walked
    density[:, 2048:3072] = 0.5                   # stage 2: dense, MMA
    density[128:256, 3072:] = 0.02                # stages 3-4 of row block 1 only
    density[256:, :] = 0.0                        # row block 2: empty
    density[256:, 4095] = 1.0                     # but for one column
    return density


def _list_full_density(cuda):
    """20 stages of about 480 set bits each per 128-row block: each is walked
    (fewer than 512) until the row block's list of 8192 entries is full after
    17, and the stages that no longer fit run on the MMA."""
    return torch.full((300, 20 * 1024), 480 / (128 * 1024), device=cuda)


@pytest.mark.parametrize("density", [_mixed_density, _list_full_density],
                         ids=["mixed", "list_full"])
def test_skip_walk_and_mma_stages_in_one_launch(cuda, density):
    gen = torch.Generator(device=cuda).manual_seed(7)
    dens = density(cuda)
    rows, k, n = dens.shape[0], dens.shape[1], 700
    a = pack_bits(torch.rand((rows, k), generator=gen, device=cuda) < dens)
    b = pack_bits(torch.rand((k, n), generator=gen, device=cuda) < 0.05)
    cur = pack_bits(torch.rand((rows, n), generator=gen, device=cuda) < 0.05)
    _both_match_plain(a, b, cur)
    torch.cuda.synchronize()


def test_bitmm_on_a_second_device(cuda):
    """The MMA kernel's shared-memory limit is set per device: after launches
    on cuda:0, launches on cuda:1 must run and agree too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        gen = torch.Generator(device=dev).manual_seed(3)
        a = pack_bits(torch.rand((300, 2100), generator=gen, device=dev) < 0.5)
        b = pack_bits(torch.rand((2100, 700), generator=gen, device=dev) < 0.05)
        cur = pack_bits(torch.rand((300, 700), generator=gen, device=dev) < 0.05)
        _both_match_plain(a, b, cur)
        torch.cuda.synchronize(dev)


def test_bit_31_of_every_word(cuda):
    """Only bit 31 of each word set in A, B and M: the sign bit of int32."""
    rows, k, n = 200, 33 * 32, 300
    a = torch.full((rows, k // 32), -(2**31), dtype=torch.int32, device=cuda)
    b = torch.full((k, (n + 31) // 32), -(2**31), dtype=torch.int32, device=cuda)
    cur = torch.full((rows, b.shape[1]), -(2**31), dtype=torch.int32, device=cuda)
    cur[::2] = 0
    _both_match_plain(a, b, cur)
    assert bool((kb.bitmm(a, b) == -(2**31)).all())
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


# (B, K, N, D): test_gather_sum_sweep's shapes, then D off the 16-byte vector
# width (the scalar path), a bag longer than a warp, and a grid-stride run
GATHER_SHAPES = [(8, 3, 20, 128), (16, 7, 50, 256), (4, 1, 5, 384), (9, 5, 30, 99),
                 (5, 40, 64, 36), (70_000, 8, 1000, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gather_sum_matches_plain(cuda, dtype, shape):
    b, k, n, d = shape
    rng = np.random.default_rng(b + k)
    idx = torch.as_tensor(rng.integers(-1, n, size=(b, k)).astype(np.int32), device=cuda)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=cuda).to(dtype)
    before = kg.gather_sum.launches
    got = kg.gather_sum(idx, x)
    assert kg.gather_sum.launches == before + 1
    want = gather_sum_plain(idx, x)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_sum_unaligned_rows_and_out_of_range_ids(cuda, dtype):
    """x starting one element past a 16-byte boundary takes the scalar path;
    a bag holding an id ≥ N is NaN and reads no row."""
    rng = np.random.default_rng(0)
    flat = torch.as_tensor(rng.standard_normal(1 + 40 * 64).astype(np.float32), device=cuda)
    x = flat.to(dtype)[1:].view(40, 64)
    idx = torch.as_tensor(rng.integers(-1, 40, size=(12, 6)).astype(np.int32), device=cuda)
    idx[3, 2] = 40
    idx[7, 0] = 2**31 - 1
    got, want = kg.gather_sum(idx, x), gather_sum_plain(idx, x)
    assert got[[3, 7]].isnan().all() and not got[[0, 1, 2, 4, 5, 6]].isnan().any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, equal_nan=True)


def test_two_tower_on_cuda_matches_cpu(cuda):
    model = TwoTower(SMOKE, torch.Generator().manual_seed(1), device="cpu")
    gpu = TwoTower(SMOKE, device=cuda)
    gpu.load_state_dict(model.state_dict())
    stream = RecsysStream(SMOKE.user_vocab, SMOKE.item_vocab, SMOKE.user_fields,
                          SMOKE.item_fields, SMOKE.field_hots, SMOKE.n_dense_feat, batch=64)
    batch = stream.batch(0)
    cpu_b = {k: torch.as_tensor(v) for k, v in batch.items()}
    gpu_b = {k: v.to(cuda) for k, v in cpu_b.items()}
    before = kg.gather_sum.launches
    got = gpu.serve_scores(gpu_b)
    assert kg.gather_sum.launches == before + SMOKE.user_fields + SMOKE.item_fields
    torch.testing.assert_close(got.cpu(), model.serve_scores(cpu_b), atol=1e-4, rtol=1e-4)
