"""Kernels' plain versions against the Pallas kernels, wrapper dispatch and
argument checks.

The reference runs ``repro.kernels.ops`` as ``tests/test_kernels.py`` does
(Pallas interpret mode on the CPU).  PBME products are packed words and must
be equal bit for bit; gather-sum is held to ``test_gather_sum_sweep``'s
tolerances (float32 1e-5, bfloat16 2e-2).  The CUDA kernels themselves run
only on the card: ``test_torch_cuda.py`` holds them against the plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.relational.embedding import embedding_bag as ref_embedding_bag
from repro_torch.kernels import bitmm as kb
from repro_torch.kernels import dense_agg as kd
from repro_torch.kernels import gather_sum as kg
from repro_torch.kernels.ref import (
    bitmm_fused_delta_plain, bitmm_plain, dense_agg_update_plain, gather_sum_plain, pack_bits,
)

SHAPES = [(128, 128, 128), (130, 70, 200), (64, 33, 97)]


def _pack(dense: np.ndarray) -> np.ndarray:
    """bool[r, c] → uint32[r, ceil(c/32)], the reference's layout."""
    r, c = dense.shape
    d = np.pad(dense, ((0, 0), (0, (-c) % 32))).astype(np.uint32).reshape(r, -1, 32)
    return (d << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(words).view(np.int32))


def _operands(shape, density, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = _pack(rng.random((m, k)) < density)
    b = _pack(rng.random((k, n)) < density)
    cur = _pack(rng.random((m, n)) < 0.05)
    return a, b, cur


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", [0.02, 0.3])
def test_plain_matches_pallas(shape, density):
    a, b, cur = _operands(shape, density, sum(shape))
    expect = np.asarray(ops.bitmm(jnp.asarray(a), jnp.asarray(b)))
    got = kb.bitmm(_t(a), _t(b)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, expect)
    e_delta, e_m = ops.bitmm_fused_delta(jnp.asarray(a), jnp.asarray(b), jnp.asarray(cur))
    g_delta, g_m = kb.bitmm_fused_delta(_t(a), _t(b), _t(cur))
    np.testing.assert_array_equal(g_delta.numpy().view(np.uint32), np.asarray(e_delta))
    np.testing.assert_array_equal(g_m.numpy().view(np.uint32), np.asarray(e_m))


def test_empty_and_full():
    z = np.zeros((128, 4), np.uint32)
    f = np.full((128, 4), 0xFFFFFFFF, np.uint32)
    for x, y in ((z, z), (f, f), (z, f), (f, z)):
        expect = np.asarray(ops.bitmm(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_array_equal(kb.bitmm(_t(x), _t(y)).numpy().view(np.uint32), expect)
    delta, m = kb.bitmm_fused_delta(_t(f), _t(f), _t(z))
    assert (delta.numpy().view(np.uint32) == 0xFFFFFFFF).all()
    assert (m.numpy().view(np.uint32) == 0xFFFFFFFF).all()


def test_bits_past_k_are_ignored():
    """A's words may carry bits for columns ≥ K; the product ignores them."""
    rng = np.random.default_rng(1)
    a = rng.integers(-(2**31), 2**31, size=(40, 2), dtype=np.int64).astype(np.int32)
    b = _t(_pack(rng.random((33, 50)) < 0.3))
    masked = a.copy()
    masked[:, 1] &= 1                                    # K = 33: one bit of word 1
    np.testing.assert_array_equal(
        bitmm_plain(torch.as_tensor(a), b).numpy(), bitmm_plain(torch.as_tensor(masked), b).numpy()
    )


def test_cpu_tensors_take_the_plain_version():
    a, b, cur = _operands((64, 33, 97), 0.3, 0)
    before = (kb.bitmm.launches, kb.bitmm_fused_delta.launches)
    assert torch.equal(kb.bitmm(_t(a), _t(b)), bitmm_plain(_t(a), _t(b)))
    for x, y in zip(kb.bitmm_fused_delta(_t(a), _t(b), _t(cur)),
                    bitmm_fused_delta_plain(_t(a), _t(b), _t(cur))):
        assert torch.equal(x, y)
    assert (kb.bitmm.launches, kb.bitmm_fused_delta.launches) == before == (0, 0)


def _bad_calls():
    a = torch.zeros((8, 2), dtype=torch.int32)
    b = torch.zeros((40, 3), dtype=torch.int32)
    m = torch.zeros((8, 3), dtype=torch.int32)
    return [
        ("int32", lambda: kb.bitmm(a.long(), b)),
        ("int32", lambda: kb.bitmm(a, b.to(torch.uint8))),
        ("int32", lambda: kb.bitmm(a.float(), b)),
        ("2-D", lambda: kb.bitmm(a[0], b)),
        ("words per row", lambda: kb.bitmm(torch.zeros((8, 1), dtype=torch.int32), b)),
        ("words per row", lambda: kb.bitmm(torch.zeros((8, 3), dtype=torch.int32), b)),
        ("contiguous", lambda: kb.bitmm(torch.zeros((2, 8), dtype=torch.int32).T, b)),
        ("m has shape", lambda: kb.bitmm_fused_delta(a, b, m[:, :2].contiguous())),
        ("int32", lambda: kb.bitmm_fused_delta(a, b, m.long())),
        ("cuda or cpu", lambda: kb.bitmm(a.to("meta"), b.to("meta"))),
        ("is on", lambda: kb.bitmm(a, b.to("meta"))),
    ]


@pytest.mark.parametrize("match, call", _bad_calls(), ids=[f"bad{i}" for i in range(11)])
def test_wrappers_refuse_bad_arguments(match, call):
    """Checked before any dispatch, so the CUDA route refuses them too."""
    with pytest.raises(ValueError, match=match):
        call()
    assert (kb.bitmm.launches, kb.bitmm_fused_delta.launches) == (0, 0)


def test_wrappers_refuse_more_words_than_the_grid_holds():
    """Blocks along the output words are grid y: at most 65535 of 8 words."""
    a = torch.zeros((1, 1), dtype=torch.int32)
    b = torch.zeros((1, kb._MAX_GRID_Y * kb._WORDS_PER_BLOCK + 1), dtype=torch.int32)
    m = torch.zeros((1, b.shape[1]), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceed the grid"):
        kb.bitmm(a, b)
    with pytest.raises(ValueError, match="exceed the grid"):
        kb.bitmm_fused_delta(a, b, m)
    ok = torch.zeros((1, kb._MAX_GRID_Y * kb._WORDS_PER_BLOCK), dtype=torch.int32)
    assert kb.bitmm(a, ok).shape == (1, ok.shape[1])
    assert (kb.bitmm.launches, kb.bitmm_fused_delta.launches) == (0, 0)


def test_pack_bits_wraps_bit_31():
    dense = torch.zeros((1, 40), dtype=torch.bool)
    dense[0, 31] = dense[0, 32] = True
    assert pack_bits(dense).tolist() == [[-(2**31), 1]]


# -- gather-sum ---------------------------------------------------------------

GATHER_SHAPES = [(8, 3, 20, 128), (16, 7, 50, 256), (4, 1, 5, 384)]   # test_gather_sum_sweep
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _gather_inputs(bk, seed):
    b, k, n, d = bk
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, n, size=(b, k)).astype(np.int32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return idx, x


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bk", GATHER_SHAPES)
def test_gather_sum_matches_pallas(dtype, bk):
    idx, x = _gather_inputs(bk, bk[0] + bk[1])
    xj = jnp.asarray(x, dtype)
    expect = np.asarray(ops.spmm_ell(jnp.asarray(idx), xj), np.float32)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(TORCH_DTYPES[dtype])
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    for fn in (gather_sum_plain, kg.gather_sum, kg.spmm_ell,
               lambda i, t: kg.embed_bag(t, i)):
        got = fn(torch.as_tensor(idx), xt)
        assert got.dtype == xt.dtype and tuple(got.shape) == (idx.shape[0], x.shape[1])
        np.testing.assert_allclose(got.float().numpy(), expect, atol=tol, rtol=tol)


def test_gather_sum_matches_relational_reference():
    """The port's kernel route equals the reference's ``embedding_bag``, which
    the model calls (``test_embed_bag_matches_relational_reference``)."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((40, 128)).astype(np.float32)
    idx = rng.integers(-1, 40, size=(6, 5)).astype(np.int32)
    expect = np.asarray(ref_embedding_bag(jnp.asarray(table), jnp.asarray(idx)))
    got = kg.embed_bag(torch.as_tensor(table), torch.as_tensor(idx)).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-5)


def test_gather_sum_out_of_range_id_is_nan():
    """A bag holding an id ≥ N is NaN, as ``jnp.take``'s fill mode makes it in
    the reference's ``embedding_bag``; other bags are untouched."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((10, 8)).astype(np.float32)
    idx = np.array([[1, 2, -1], [0, 10, -1], [-1, -1, -1], [9, 12, 3]], np.int32)
    expect = np.asarray(ref_embedding_bag(jnp.asarray(table), jnp.asarray(idx)))
    assert np.isnan(expect[[1, 3]]).all() and not np.isnan(expect[[0, 2]]).any()
    for dtype in (torch.float32, torch.bfloat16):
        got = kg.gather_sum(torch.as_tensor(idx), torch.as_tensor(table).to(dtype))
        np.testing.assert_allclose(got.float().numpy(), expect,
                                   atol=1e-5 if dtype == torch.float32 else 2e-2)


def test_gather_sum_accumulates_bf16_in_float32():
    """Rows are summed in float32 and rounded once: 256 + 1 + 1 + ... stays
    exact where a bfloat16 running sum would drop each 1."""
    x = torch.tensor([[256.0], [1.0]], dtype=torch.bfloat16)
    idx = torch.tensor([[0] + [1] * 8], dtype=torch.int32)
    assert kg.gather_sum(idx, x).item() == 264.0


def test_gather_sum_edges_and_cpu_route():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    assert kg.gather_sum(torch.zeros((0, 2), dtype=torch.int32), x).shape == (0, 3)
    assert kg.gather_sum(torch.zeros((3, 0), dtype=torch.int32), x).eq(0).all()
    assert kg.gather_sum(torch.full((2, 3), -1, dtype=torch.int32), x).eq(0).all()
    assert kg.gather_sum.launches == 0


def _bad_gather_calls():
    idx = torch.zeros((4, 3), dtype=torch.int32)
    x = torch.zeros((10, 8), dtype=torch.float32)
    w = torch.zeros((10, 8), dtype=torch.float32, requires_grad=True)
    return [
        ("torch.int32", lambda: kg.gather_sum(idx.long(), x)),
        ("torch.int32", lambda: kg.gather_sum(idx[0], x)),
        ("float32 or bfloat16", lambda: kg.gather_sum(idx, x.half())),
        ("float32 or bfloat16", lambda: kg.gather_sum(idx, x.double())),
        ("float32 or bfloat16", lambda: kg.gather_sum(idx, x[None])),
        ("contiguous", lambda: kg.gather_sum(torch.zeros((3, 4), dtype=torch.int32).T, x)),
        ("contiguous", lambda: kg.gather_sum(idx, torch.zeros((8, 10)).T)),
        ("no rows", lambda: kg.gather_sum(idx, x[:0])),
        ("exceed", lambda: kg.gather_sum(torch.zeros((1, kg.MAX_K + 1), dtype=torch.int32), x)),
        ("no backward", lambda: kg.gather_sum(idx, w)),
        ("cuda or cpu", lambda: kg.gather_sum(idx.to("meta"), x.to("meta"))),
        ("is on", lambda: kg.gather_sum(idx, x.to("meta"))),
    ]


@pytest.mark.parametrize("match, call", _bad_gather_calls(),
                         ids=[f"bad{i}" for i in range(12)])
def test_gather_sum_refuses_bad_arguments(match, call):
    """Checked before any dispatch, so the CUDA route refuses them too; the
    tower hands each table's ids over as one contiguous [B·F, K] view."""
    with pytest.raises(ValueError, match=match):
        call()
    assert kg.gather_sum.launches == 0


def _agg_operands(slots=64, n=20):
    rng = np.random.default_rng(slots)
    values = torch.as_tensor(rng.integers(-50, 50, size=n).astype(np.int32))
    keys = torch.as_tensor(rng.integers(-5, n + 5, size=slots).astype(np.int32))
    vals = torch.as_tensor(rng.integers(-60, 60, size=slots).astype(np.int32))
    return values, keys, vals, torch.as_tensor(rng.random(slots) < 0.7)


@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_dense_agg_cpu_tensors_take_the_plain_version(op):
    """The CPU route is the plain version, launches nothing, reports no
    atomics and leaves the old table as it was."""
    values, keys, vals, valid = _agg_operands()
    before = values.clone()
    got = kd.dense_agg_update(values, op, [(keys, vals, valid), (vals, keys, ~valid)])
    want = dense_agg_update_plain(values, op, [(keys, vals, valid), (vals, keys, ~valid)])
    assert torch.equal(got.values, want[0]) and torch.equal(got.delta, want[1])
    assert (got.candidates, got.count, got.delta_count) == want[2:] and got.candidates == 64
    assert got.atomics is None and kd.dense_agg_update.launches == 0
    assert torch.equal(values, before)


def _bad_agg_calls():
    values, keys, vals, valid = _agg_operands()
    return [
        ("'MIN' or 'MAX'", lambda: kd.dense_agg_update(values, "SUM", [])),
        ("values must be", lambda: kd.dense_agg_update(values.long(), "MIN", [])),
        ("values must be", lambda: kd.dense_agg_update(values[None], "MIN", [])),
        ("keys must be", lambda: kd.dense_agg_update(values, "MIN", [(keys.long(), vals, valid)])),
        ("vals must be", lambda: kd.dense_agg_update(values, "MIN", [(keys, vals[None], valid)])),
        ("valid must be", lambda: kd.dense_agg_update(values, "MIN", [(keys, vals, valid.int())])),
        ("shapes", lambda: kd.dense_agg_update(values, "MIN", [(keys, vals[:3], valid)])),
        ("cuda or cpu", lambda: kd.dense_agg_update(values.to("meta"), "MIN", [])),
        ("is on", lambda: kd.dense_agg_update(values, "MIN", [(keys.to("meta"), vals, valid)])),
    ]


@pytest.mark.parametrize("match, call", _bad_agg_calls(), ids=[f"bad{i}" for i in range(9)])
def test_dense_agg_refuses_bad_arguments(match, call):
    """Checked before any dispatch, so the CUDA route refuses them too."""
    with pytest.raises(ValueError, match=match):
        call()
    assert kd.dense_agg_update.launches == 0
