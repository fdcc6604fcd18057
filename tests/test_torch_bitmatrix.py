"""PBME fixpoint loops: the port's ``tc_fixpoint``/``sg_fixpoint`` against the
reference's, with the reference run both on its jnp path and through its
Pallas kernels (interpret mode).  Packed matrices and iteration counts must
be equal exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import random_edges
from repro.core import bitmatrix as ref
from repro.core.relation import SENTINEL, next_bucket
from repro.core.relation import TupleRelation as RefTupleRelation
from repro_torch.core import bitmatrix as port
from repro_torch.core.relation import TupleRelation as PortTupleRelation
from repro_torch.interop import bitmatrix_to_reference
from repro_torch.kernels import bitpack

GRAPHS = [(40, 90, 0), (120, 200, 1), (200, 420, 2)]   # (n, m, seed)


def _arcs(n, m, seed):
    edges = random_edges(np.random.default_rng(seed), n, m)
    return edges, ref.edges_to_bitmatrix(edges, n), port.edges_to_bitmatrix(
        torch.as_tensor(edges), n
    )


def _same(ref_packed, port_packed):
    np.testing.assert_array_equal(np.asarray(ref_packed), bitmatrix_to_reference(port_packed))


@pytest.mark.parametrize("n, m, seed", GRAPHS)
def test_primitives_match(n, m, seed):
    _edges, r_arc, p_arc = _arcs(n, m, seed)
    _same(r_arc, p_arc)
    _same(ref.transpose_packed(r_arc, n), port.transpose_packed(p_arc, n))
    assert int(ref.popcount(r_arc)) == int(port.popcount(p_arc))
    rows, count = port.bitmatrix_to_table(p_arc, n)
    np.testing.assert_array_equal(ref.bitmatrix_to_edges(r_arc, n), rows[:count].numpy())


@pytest.mark.parametrize("kind", ["tc", "sg"])
@pytest.mark.parametrize("n, m, seed", GRAPHS)
def test_fixpoints_match_jnp_path(kind, n, m, seed):
    _edges, r_arc, p_arc = _arcs(n, m, seed)
    r_m, r_it = getattr(ref, f"{kind}_fixpoint")(r_arc, n, use_pallas=False)
    p_m, p_it = getattr(port, f"{kind}_fixpoint")(p_arc, n)
    assert r_it == p_it
    _same(r_m, p_m)


@pytest.mark.parametrize("kind", ["tc", "sg"])
def test_fixpoints_match_pallas_path(kind):
    n, m, seed = GRAPHS[0]
    _edges, r_arc, p_arc = _arcs(n, m, seed)
    r_m, r_it = getattr(ref, f"{kind}_fixpoint")(r_arc, n, use_pallas=True)
    p_m, p_it = getattr(port, f"{kind}_fixpoint")(p_arc, n)
    assert r_it == p_it
    _same(r_m, p_m)


def test_closure_rows_match_from_numpy():
    """The device-side matrix → tuple conversion gives the rows, count and
    capacity that the reference builds through numpy."""
    n, m, seed = GRAPHS[2]
    _edges, r_arc, p_arc = _arcs(n, m, seed)
    r_m, _ = ref.tc_fixpoint(r_arc, n)
    p_m, _ = port.tc_fixpoint(p_arc, n)
    expect = RefTupleRelation.from_numpy("tc", ref.bitmatrix_to_edges(r_m, n), n)
    rows, count = port.bitmatrix_to_table(p_m, n)
    assert count == expect.count > 1000
    np.testing.assert_array_equal(np.asarray(expect.rows), rows.numpy())
    store = {"arc": PortTupleRelation.from_numpy("arc", _edges, n, "cpu")}
    plan = port.BitmatrixPlan("tc", "tc", "arc", n)
    plan.execute(store, SimpleNamespace(domain=n))
    got = store["tc"]
    assert (got.count, got.capacity) == (expect.count, expect.capacity)
    np.testing.assert_array_equal(np.asarray(expect.rows), got.rows.numpy())


def _conversion_case(n, kind, seed):
    """Edges for a conversion case, shuffled and with a third of them twice."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        edges = np.zeros((0, 2), np.int32)
    elif kind == "full":
        edges = np.argwhere(np.ones((n, n), bool)).astype(np.int32)
    elif kind == "sign_bit":            # column 31 of a word: bit 31, the sign of int32
        edges = np.array([[0, 31], [n - 1, 31], [n // 2, 31]], np.int32) % n
    else:
        edges = random_edges(rng, n, 3 * n)
    edges = np.concatenate([edges, edges[: len(edges) // 3]])
    return edges[rng.permutation(len(edges))]


@pytest.mark.parametrize("n, kind, capacity_min", [
    (1, "empty", 128), (1, "full", 128), (31, "random", 128), (32, "full", 128),
    (32, "sign_bit", 128), (33, "sign_bit", 128), (33, "random", 128),
    (100, "random", 128), (100, "random", 4096), (100, "empty", 256), (100, "full", 128),
])
def test_conversions_match_the_reference(n, kind, capacity_min):
    """The conversions' CPU path and ``BitmatrixPlan.execute`` give the
    reference's packed matrix and its rows, count and capacity bit for bit,
    from unsorted edges with repeats."""
    edges = _conversion_case(n, kind, seed=n)
    r_arc = ref.edges_to_bitmatrix(edges, n)
    p_arc = bitpack.edges_to_bitmatrix(torch.as_tensor(edges), n)
    _same(r_arc, p_arc)
    pairs = ref.bitmatrix_to_edges(r_arc, n)
    want = np.full((next_bucket(len(pairs), capacity_min), 2), SENTINEL, np.int32)
    want[: len(pairs)] = pairs
    rows, count = bitpack.bitmatrix_to_table(p_arc, n, capacity_min)
    assert count == len(pairs) == len(np.unique(edges, axis=0))
    np.testing.assert_array_equal(rows.numpy(), want)

    r_m, _ = ref.tc_fixpoint(r_arc, n)
    expect = RefTupleRelation.from_numpy("tc", ref.bitmatrix_to_edges(r_m, n), n)
    store = {"arc": PortTupleRelation.from_numpy("arc", edges, n, "cpu")}
    port.BitmatrixPlan("tc", "tc", "arc", n).execute(store, SimpleNamespace(domain=n))
    got = store["tc"]
    assert (got.count, got.capacity) == (expect.count, expect.capacity)
    np.testing.assert_array_equal(np.asarray(expect.rows), got.rows.numpy())


@pytest.mark.parametrize("n", [1, 33, 100])
def test_pairs_outside_the_matrix_are_skipped(n):
    """A pair outside ``[0, n) × [0, n)`` sets no bit: the CPU path gives the
    reference's matrix of the pairs inside, as the card does."""
    rng = np.random.default_rng(n)
    inside = random_edges(rng, n, 3 * n)
    outside = np.array([[n, 0], [0, n], [-1, 0], [0, -1], [n + 40, n + 40]], np.int32)
    edges = np.concatenate([inside, outside])
    edges = edges[rng.permutation(len(edges))]
    _same(ref.edges_to_bitmatrix(inside, n), bitpack.edges_to_bitmatrix(torch.as_tensor(edges), n))


# --------------------------------------------------------------------------
# the serving increments: row-compacted products at M = k and K = k
# --------------------------------------------------------------------------


def _heads_delta(rng, n, base, k):
    """New edges whose destinations are exactly ``k`` distinct nodes, none
    already in ``base``."""
    have = set(map(tuple, base.tolist()))
    dst = rng.choice(n, size=k, replace=False)
    out = []
    for d in dst:
        for s in rng.permutation(n):
            if (int(s), int(d)) not in have:
                out.append((int(s), int(d)))
                break
    return np.array(out, np.int32)


def _frontier(rng, n, k):
    return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)


@pytest.mark.parametrize("k", [1, 5, 48, 49])
def test_tc_and_sg_increments_match(k):
    """Frontiers of 1, 5 and n // 2 heads take the compacted products; one
    more head takes the full product, on both sides."""
    n = 96
    rng = np.random.default_rng(k)
    base = random_edges(rng, n, 150)
    extra = _heads_delta(rng, n, base, k)
    both = np.concatenate([base, extra])
    r0, r1 = ref.edges_to_bitmatrix(base, n), ref.edges_to_bitmatrix(both, n)
    p0 = port.edges_to_bitmatrix(torch.as_tensor(base), n)
    p1 = port.edges_to_bitmatrix(torch.as_tensor(both), n)
    rd, pd = r1 & ~r0, p1 & ~p0
    assert len(port._frontier_rows(port.transpose_packed(pd, n))) == k
    for kind in ("tc", "sg"):
        r_m0, _ = getattr(ref, f"{kind}_fixpoint")(r0, n)
        p_m0, _ = getattr(port, f"{kind}_fixpoint")(p0, n)
        r_m, r_it = getattr(ref, f"{kind}_increment")(r_m0, r1, rd, n, use_pallas=False)
        p_m, p_it = getattr(port, f"{kind}_increment")(p_m0, p1, pd, n)
        assert r_it == p_it, kind
        _same(r_m, p_m)
        full, _ = getattr(port, f"{kind}_fixpoint")(p1, n)
        assert torch.equal(p_m, full), kind


def test_increments_with_no_new_edges_are_noops():
    n = 40
    _edges, _r_arc, p_arc = _arcs(n, 90, 0)
    zero = p_arc & ~p_arc
    for kind in ("tc", "sg"):
        m, _ = getattr(port, f"{kind}_fixpoint")(p_arc, n)
        got, iters = getattr(port, f"{kind}_increment")(m, p_arc, zero, n)
        assert got is m and iters == 0


@pytest.mark.parametrize("k", [1, 5, 48])
def test_compacted_products_match(k):
    n = 96
    rng = np.random.default_rng(10 + k)
    edges_a, edges_b = random_edges(rng, n, 200), random_edges(rng, n, 160)
    ra, rb = ref.edges_to_bitmatrix(edges_a, n), ref.edges_to_bitmatrix(edges_b, n)
    pa = port.edges_to_bitmatrix(torch.as_tensor(edges_a), n)
    pb = port.edges_to_bitmatrix(torch.as_tensor(edges_b), n)
    rows = _frontier(rng, n, k)
    prow = torch.as_tensor(rows)
    _same(ref.bitmm_rows(ra, rb, n, rows), port.bitmm_rows(pa, pb, n, prow))
    _same(
        ref.bitmm_chain_rows(ra, (rb, ra), n, rows),
        port.bitmm_chain_rows(pa, (pb, pa), n, prow),
    )
    # a symmetric Δ whose nonzero rows are the frontier, as in sg_increment
    mask = np.zeros((n, n), bool)
    mask[rows] = True
    sym = np.asarray(ref.unpack_bits(rb, n)) & mask
    sym = sym | sym.T
    rows_sym = np.flatnonzero(sym.any(axis=1))
    r_delta = ref.pack_bits(sym)
    p_delta = port.pack_bits(torch.as_tensor(sym))
    _same(
        ref._sandwich_rows(r_delta, ra, n, rows_sym),
        port._sandwich_rows(p_delta, pa, n, torch.as_tensor(rows_sym)),
    )


def test_rectangular_transpose_and_row_popcounts():
    n, k = 70, 9
    rng = np.random.default_rng(3)
    dense = rng.random((k, n)) < 0.2
    packed = port.pack_bits(torch.as_tensor(dense))
    t = port.transpose_packed(packed, n)
    assert tuple(t.shape) == (n, 1)
    np.testing.assert_array_equal(port.unpack_bits(t, k).numpy(), dense.T)
    np.testing.assert_array_equal(
        port.popcount_rows(packed).numpy(),
        np.asarray(ref.popcount_rows(ref.pack_bits(dense))).astype(np.int32),
    )
    np.testing.assert_array_equal(
        port._frontier_rows(packed).numpy(), np.flatnonzero(dense.any(axis=1))
    )
