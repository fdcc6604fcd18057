"""Relation handles: the port's against ``repro.core.relation``, and state
carried across with ``repro_torch.interop``.

Handles are compared through ``to_blocks()``: same meta, byte-identical
arrays (rows with their SENTINEL pads, so capacities too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.datalog_workloads import ALL
from repro.core import Engine as RefEngine
from repro.core import relation as ref
from repro_torch import interop
from repro_torch.core import relation as port
from torch_parity import assert_blocks_equal

DOMAINS = [(2, 40), (3, 2_000)]   # (arity, domain): compact key / lexsort fallback


def _rows(rng, n, arity, domain):
    return rng.integers(0, domain, size=(n, arity)).astype(np.int32)


def _same(r, p):
    assert_blocks_equal({"x": r.to_blocks()}, {"x": p.to_blocks()})


def _same_array(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("arity, domain", DOMAINS)
def test_tuple_relation_ops(arity, domain):
    rng = np.random.default_rng(arity)
    data = _rows(rng, 300, arity, domain)
    r = ref.TupleRelation.from_numpy("t", data, domain)
    p = port.TupleRelation.from_numpy("t", data, domain, "cpu")
    _same(r, p)
    for col in range(arity):
        for a, b in zip(r.sorted_by(col), p.sorted_by(col)):
            _same_array(a, b)

    more = np.concatenate([data[:50], _rows(rng, 200, arity, domain)])
    r2, rd, rc = r.insert(more)
    p2, pd, pc = p.insert(more)
    assert rc == pc
    _same_array(rd, pd)
    _same(r2, p2)

    gone = np.concatenate([more[::3], _rows(rng, 40, arity, domain), [[domain] * arity]])
    r3, rrem, rcount = r2.delete(gone)
    p3, prem, pcount = p2.delete(gone)
    assert rcount == pcount > 0
    _same_array(rrem, prem)
    _same(r3, p3)


@pytest.mark.parametrize("arity, domain", DOMAINS)
def test_merge_sorted_and_dedup(arity, domain):
    rng = np.random.default_rng(7)
    a = np.unique(_rows(rng, 200, arity, domain), axis=0)
    b = np.unique(_rows(rng, 150, arity, domain), axis=0)
    b = b[~(b[:, None, :] == a[None]).all(-1).any(1)]              # disjoint from a
    cap = port.next_bucket(len(a) + len(b))
    ra = ref._sort_pad(jnp.asarray(a), port.next_bucket(len(a)), domain)
    rb = ref._sort_pad(jnp.asarray(b), port.next_bucket(len(b)), domain)
    pa = port._sort_pad(torch.as_tensor(a), port.next_bucket(len(a)), domain)
    pb = port._sort_pad(torch.as_tensor(b), port.next_bucket(len(b)), domain)
    _same_array(ra, pa)
    _same_array(ref._merge_sorted(ra, rb, cap, domain), port._merge_sorted(pa, pb, cap, domain))
    dup = np.concatenate([a, a[:30]])
    rs = ref._sort_pad(jnp.asarray(dup), 512, domain)
    ps = port._sort_pad(torch.as_tensor(dup), 512, domain)
    (rd, rn), (pd, pn) = ref._dedup_sorted(rs, domain), port._dedup_sorted(ps, domain)
    assert int(rn) == pn
    _same_array(rd, pd)


def _upload_case(name):
    """(arity, domain, rows) of one upload case; ``rows`` may be 1-D."""
    rng = np.random.default_rng(len(name))
    if name == "dense_duplicates":
        return 2, 12, _rows(rng, 600, 2, 12)
    if name == "count_under_bucket":        # 200 rows in, 100 distinct: capacity 128
        distinct = np.unique(_rows(rng, 400, 2, 40), axis=0)[:100]
        return 2, 40, rng.permutation(np.concatenate([distinct, distinct]))
    if name == "empty":
        return 2, 40, np.zeros((0, 2), np.int32)
    if name == "one_dimensional":
        return 1, 50, rng.integers(0, 50, size=90).astype(np.int32)
    if name == "arity3_lexsort":
        data = _rows(rng, 300, 3, 2_000)
        return 3, 2_000, np.concatenate([data, data[::4]])
    assert name == "out_of_domain"            # the compact key aliases such rows
    data = rng.integers(-3, 45, size=(300, 2)).astype(np.int32)
    return 2, 40, np.concatenate([data, data[:60], [[2**31 - 1, -2**31]] * 2])


@pytest.mark.parametrize("case", ["dense_duplicates", "count_under_bucket", "empty",
                                  "one_dimensional", "arity3_lexsort", "out_of_domain"])
def test_upload_dedup_matches_reference(case):
    """``from_numpy``, ``insert`` and ``delete`` dedup their rows on the
    device: rows, count and capacity equal the reference's bit for bit."""
    arity, domain, data = _upload_case(case)
    r = ref.TupleRelation.from_numpy("t", data, domain)
    p = port.TupleRelation.from_numpy("t", data, domain, "cpu")
    _same(r, p)
    assert p.capacity == port.next_bucket(len(np.unique(data.reshape(-1, arity), axis=0)))
    if case == "count_under_bucket":
        assert (p.count, p.capacity) == (100, 128)

    rng = np.random.default_rng(11)
    base = np.unique(_rows(rng, 60, arity, domain), axis=0)
    rb = ref.TupleRelation.from_numpy("t", base, domain)
    pb = port.TupleRelation.from_numpy("t", base, domain, "cpu")
    r2, rd, rc = rb.insert(data)
    p2, pd, pc = pb.insert(data)
    assert rc == pc
    _same_array(rd, pd)
    _same(r2, p2)
    r3, rrem, rcount = r2.delete(data)
    p3, prem, pcount = p2.delete(data)
    assert rcount == pcount
    _same_array(rrem, prem)
    _same(r3, p3)


@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_dense_handles_update(op):
    rng = np.random.default_rng(3)
    n = 50
    ra, pa = ref.DenseAggRelation.empty("a", n, op), port.DenseAggRelation.empty("a", n, op, "cpu")
    rs, ps = ref.DenseSetRelation.empty("s", n), port.DenseSetRelation.empty("s", n, "cpu")
    for _ in range(3):
        keys = rng.integers(0, n, size=80).astype(np.int32)
        vals = rng.integers(-100, 100, size=80).astype(np.int32)
        valid = rng.random(80) < 0.7
        ra = ra.update(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
        pa = pa.update(torch.as_tensor(keys), torch.as_tensor(vals), torch.as_tensor(valid))
        rs = rs.update(jnp.asarray(keys), jnp.asarray(valid))
        ps = ps.update(torch.as_tensor(keys), torch.as_tensor(valid))
        for r, p in ((ra, pa), (rs, ps)):
            _same(r, p)
            assert (r.count, r.delta_count) == (p.count, p.delta_count)
            _same_array(r.delta_tuples(128)[0], p.delta_tuples(128)[0])
        _same_array(ra.full_tuples(16)[0], pa.full_tuples(16)[0])


def _agg_round_case(name, rng, n):
    """(earlier single-buffer updates, the round's buffers), each buffer a
    (keys, vals, valid) triple of numpy arrays."""
    def buf(size, lo=0, hi=n, p_valid=0.8, vlo=-100, vhi=100):
        return (rng.integers(lo, hi, size=size).astype(np.int32),
                rng.integers(vlo, vhi, size=size).astype(np.int32),
                rng.random(size) < p_valid)

    warm = [buf(40, p_valid=0.5)]
    if name == "tail_pads":                      # a binding table: pads behind `total`
        keys, vals, _ = buf(256)
        return warm, [(keys, vals, np.arange(256) < 90)]
    if name == "middle_invalid":
        return warm, [buf(200, p_valid=0.5)]
    if name == "clamp":                          # valid keys below 0 and at or above n
        return warm, [buf(200, lo=-2 * n, hi=3 * n, p_valid=0.9)]
    if name == "one_key":
        keys, vals, valid = buf(300)
        keys[rng.random(300) < 0.9] = 7
        return warm, [(keys, vals, valid)]
    if name == "equal_to_current":               # only the earlier values come back
        keys, vals, valid = warm[0]
        return warm, [(keys.copy(), vals.copy(), valid.copy())]
    if name == "absent_to_present":              # an empty table's first round
        return [], [buf(120, hi=n // 2)]
    assert name == "two_buffers"
    return warm, [buf(150), buf(90, p_valid=0.6)]


@pytest.mark.parametrize("case", ["tail_pads", "middle_invalid", "clamp", "one_key",
                                  "equal_to_current", "absent_to_present", "two_buffers"])
@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_dense_agg_round_matches_reference(op, case):
    """One round of the MIN/MAX table on the CPU (``update_round``, the plain
    version) against the reference's ``update`` bit for bit: values, Δ,
    ``count`` and ``delta_count``.  The reference engine clips the keys
    first, and unions the buffers' Δ of a round."""
    rng = np.random.default_rng(len(case))
    n = 50
    warm, bufs = _agg_round_case(case, rng, n)
    ra, pa = ref.DenseAggRelation.empty("a", n, op), port.DenseAggRelation.empty("a", n, op, "cpu")
    for keys, vals, valid in warm:
        ra = ra.update(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
        pa = pa.update(torch.as_tensor(keys), torch.as_tensor(vals), torch.as_tensor(valid))
    union = jnp.zeros(n, bool)
    for keys, vals, valid in bufs:
        ra = ra.update(jnp.clip(jnp.asarray(keys), 0, n - 1), jnp.asarray(vals),
                       jnp.asarray(valid))
        union = union | ra.delta
    ra = ref.DenseAggRelation("a", n, op, ra.values, union, ra.count, int(union.sum()))
    pa, candidates, atomics = pa.update_round(
        [tuple(torch.as_tensor(a) for a in b) for b in bufs])
    _same(ra, pa)
    assert (ra.count, ra.delta_count) == (pa.count, pa.delta_count)
    assert candidates == sum(int(b[2].sum()) for b in bufs) and atomics is None
    if case == "equal_to_current":
        assert pa.delta_count == 0
    if case == "absent_to_present":
        assert pa.count == pa.delta_count > 0


def _reference_store():
    rng = np.random.default_rng(5)
    edges = np.unique(rng.integers(0, 30, size=(70, 2)), axis=0).astype(np.int32)
    src = np.array([[0]], np.int32)
    store = {}
    for name, edb in (("reach", {"id": src, "arc": edges}), ("cc", {"arc": edges}),
                      ("tc", {"arc": edges})):
        eng = RefEngine()
        eng.run(ALL[name].program, edb)
        store.update({f"{name}.{k}": h for k, h in eng.store.items()})
    return store


def test_store_from_reference_roundtrip():
    ref_store = _reference_store()
    kinds = {h.to_blocks()[0]["kind"] for h in ref_store.values()}
    assert kinds == {"tuple", "dense_set", "dense_agg"}
    blocks = {k: h.to_blocks() for k, h in ref_store.items()}
    store = interop.store_from_reference(blocks, "cpu")
    assert_blocks_equal(blocks, interop.store_to_blocks(store))
    for k, h in ref_store.items():
        np.testing.assert_array_equal(h.to_numpy(), store[k].to_numpy())
        assert h.count == store[k].count
    with pytest.raises(ValueError, match="unknown relation kind"):
        interop.store_from_reference({"x": ({"kind": "heap"}, {})}, "cpu")


def test_bitmatrix_crosses_as_int32_view():
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2**32, size=(37, 2), dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0x80000001                      # bit 31 is a real column
    t = interop.bitmatrix_from_reference(words, "cpu")
    assert t.dtype == torch.int32 and int(t[0, 0]) < 0
    back = interop.bitmatrix_to_reference(t)
    assert back.dtype == np.uint32 and back.tobytes() == words.tobytes()
