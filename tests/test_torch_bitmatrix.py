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
from repro.core.relation import TupleRelation as RefTupleRelation
from repro_torch.core import bitmatrix as port
from repro_torch.core.relation import TupleRelation as PortTupleRelation
from repro_torch.interop import bitmatrix_to_reference

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
    np.testing.assert_array_equal(
        ref.bitmatrix_to_edges(r_arc, n), port.bitmatrix_to_rows(p_arc, n).numpy()
    )


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
    pairs = port.bitmatrix_to_rows(p_m, n)
    assert pairs.shape[0] == expect.count > 1000
    store = {"arc": PortTupleRelation.from_numpy("arc", _edges, n, "cpu")}
    plan = port.BitmatrixPlan("tc", "tc", "arc", n)
    plan.execute(store, SimpleNamespace(domain=n))
    got = store["tc"]
    assert (got.count, got.capacity) == (expect.count, expect.capacity)
    np.testing.assert_array_equal(np.asarray(expect.rows), got.rows.numpy())
