"""The serving layer's retraction, transaction and snapshot paths:
``repro_torch.serve_datalog`` against ``repro.serve_datalog``, bit for bit
after every step (the harness is ``torch_parity.ServePair``).  The
scenarios are those of ``test_retraction``, ``test_transactions`` and
``test_snapshot_reads``.
"""

import numpy as np
import pytest
import torch

from conftest import random_edges
from repro.configs.datalog_workloads import ALL as WORKLOADS
from repro_torch.core import Engine, EngineConfig
from repro_torch.kernels.bitpack import bitmatrix_to_table
from repro_torch.serve_datalog import MaterializedInstance, PlanCache, TxnOp
from torch_parity import NEG_PROG, SG, TC, TWO_EDB_TC, stratum_of
from torch_parity import ServePair as Pair


# --------------------------------------------------------------------------
# retractions (test_retraction): DRed, and the full fallback
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["tuple", "auto"])
def test_tc_retractions(backend):
    edges = random_edges(np.random.default_rng(1), 30, 110)
    pair = Pair(TC, {"arc": edges}, backend=backend)
    for part in np.array_split(edges[-10:], 2):
        st = pair.delete("arc", part)
        assert st.modes == {0: "dred" if backend == "tuple" else "full"}
    pair.insert("arc", edges[-10:])                        # the round trip


def test_sg_and_negation_retractions():
    edges = random_edges(np.random.default_rng(2), 20, 55)
    for backend in ("tuple", "auto"):
        Pair(SG, {"arc": edges}, backend=backend).delete("arc", edges[-6:])
    edges = random_edges(np.random.default_rng(42), 14, 30)
    pair = Pair(NEG_PROG, {"arc": edges}, backend="tuple")
    st = pair.delete("arc", edges[-4:])
    assert st.modes[stratum_of(pair.port, "ntc")] == "full"
    assert st.modes[stratum_of(pair.port, "tc")] == "dred"
    assert st.derived > 0


def test_dense_and_aggregate_retractions():
    rng = np.random.default_rng(5)
    edges = random_edges(rng, 24, 70)
    ids = np.array([[0]], np.int32)
    st = Pair(WORKLOADS["reach"].program, {"arc": edges, "id": ids}).delete(
        "arc", edges[-8:]
    )
    assert set(st.modes.values()) == {"full"}
    Pair(WORKLOADS["cc"].program, {"arc": edges}).delete("arc", edges[-8:])
    w = np.concatenate(
        [edges, rng.integers(1, 30, size=(len(edges), 1)).astype(np.int32)], axis=1
    )
    Pair(WORKLOADS["sssp"].program, {"arc": w, "id": ids}).delete("arc", w[-8:])


def test_retract_everything_and_out_of_domain():
    edges = np.array([[0, 1], [1, 2]], np.int32)
    pair = Pair(TC, {"arc": edges}, backend="tuple")
    pair.delete("arc", edges)
    pair.insert("arc", np.array([[0, 2]], np.int32))
    edges = np.array([[0, 1], [1, 0], [1, 2]], np.int32)
    pair = Pair(TC, {"arc": edges}, backend="tuple")
    st = pair.delete("arc", np.array([[0, 3]], np.int32))
    assert st.removed == 0 and not st.modes


def test_dred_stratum_matches():
    """The engine's DRed pass on both sides: iterations and net diffs."""
    edges = random_edges(np.random.default_rng(3), 26, 80)
    pair = Pair(TWO_EDB_TC, {"arc": edges, "rail": edges[::3]}, backend="tuple")
    calls = {"ref": [], "port": []}
    for side, inst in (("ref", pair.ref), ("port", pair.port)):
        orig = inst.engine.dred_stratum

        def counting(*a, _orig=orig, _out=calls[side], **k):
            iters, net_del, net_add = _orig(*a, **k)
            _out.append((iters, {p: v.count for p, v in net_del.items()},
                         {p: v.count for p, v in net_add.items()}))
            return iters, net_del, net_add

        inst.engine.dred_stratum = counting
    pair.txn([("delete", "arc", edges[-5:]), ("insert", "rail", edges[-5:-2])])
    pair.delete("rail", edges[::3][:4])
    assert calls["port"] == calls["ref"] and len(calls["port"]) == 2


@pytest.mark.parametrize("key", ["tc/tuple", "tc/auto", "sg", "neg", "sssp"])
def test_interleaved_inserts_and_retractions(key):
    prog, cfg = {
        "tc/tuple": (TC, {"backend": "tuple"}),
        "tc/auto": (TC, {"backend": "auto"}),
        "sg": (SG, {"backend": "tuple"}),
        "neg": (NEG_PROG, {"backend": "tuple"}),
        "sssp": (WORKLOADS["sssp"].program, {}),
    }[key]
    rng = np.random.default_rng(sum(map(ord, key)))
    arity = 3 if key == "sssp" else 2
    base = np.unique(rng.integers(0, 12, size=(30, 2)), axis=0).astype(np.int32)
    if arity == 3:
        base = np.concatenate(
            [base, rng.integers(1, 9, size=(len(base), 1)).astype(np.int32)], axis=1
        )
    edb = {"arc": base}
    if key == "sssp":
        edb["id"] = np.array([[0]], np.int32)
    pair = Pair(prog, edb, **cfg)
    for _ in range(4):
        rows = rng.integers(0, 12, size=(3, 2)).astype(np.int32)
        if arity == 3:
            rows = np.concatenate(
                [rows, (1 + rows.sum(axis=1, keepdims=True) % 8).astype(np.int32)],
                axis=1,
            )
        pair.txn([(str(rng.choice(["insert", "delete"])), "arc", rows)])


def test_a_resident_stratum_hands_its_retractions_downstream():
    """A delete recomputes the resident TC stratum, whose ∇ view (from its
    packed words) reaches a positive consumer (DRed) and a negated one
    (recomputed), held to the reference after every transaction."""
    prog = NEG_PROG + "cyc(x) :- tc(x,x).\n"
    edges = random_edges(np.random.default_rng(8), 14, 34)
    pair = Pair(prog, {"arc": edges}, backend="auto")
    idx = {p: stratum_of(pair.port, p) for p in ("tc", "node", "cyc", "ntc")}
    assert list(pair.port._bm) == [idx["tc"]]
    want = {idx["tc"]: "full", idx["node"]: "dred", idx["cyc"]: "dred", idx["ntc"]: "full"}
    for part in [*np.array_split(edges[-12:], 3), edges[:5]]:
        st = pair.delete("arc", part)
        assert st.modes == want and st.retracted > 0
    pair.insert("arc", edges[-12:])


# --------------------------------------------------------------------------
# a resident PBME stratum's delete: the word diff
# --------------------------------------------------------------------------


def _complete(n):
    return np.array([(a, b) for a in range(n) for b in range(n) if a != b], np.int32)


def _diff_both_ways(inst, ops):
    """Apply ``ops`` and diff the resident stratum across them twice: its
    words (``PackedStratum.diff``) and its stored tables (``_diff``); the two
    must agree in rows, count and capacity."""
    idx = next(iter(inst._bm))
    pred = inst._bm[idx].plan.idb
    old_bm, old_table = inst._bm[idx], inst.store[pred]
    st = inst.apply_txn(ops)
    words = inst._bm[idx].diff(old_bm, inst.domain, inst.engine.config.capacity_min)
    rows = inst._diff(old_table, inst.store[pred], inst.domain)
    for w, r in zip(words, rows):
        assert (w is None) == (r is None)
        if w is not None:
            assert w[1] == r.count and torch.equal(w[0], r.rows)
    return st, words


@pytest.mark.parametrize("prog", ["tc", "sg"])
def test_the_word_diff_equals_the_row_diff(prog, tmp_path):
    """Across deletes that cut facts, deletes that change none, a delete of
    every arc, and a restored instance whose words were packed from its
    tables, the resident stratum's word diff equals the diff of its tables."""
    program = {"tc": TC, "sg": SG}[prog]
    edges = random_edges(np.random.default_rng(9), 24, 60)
    inst = MaterializedInstance(program, {"arc": edges}, cache=PlanCache(), device="cpu")
    cut = 0
    for part in np.array_split(edges[:18], 3):
        st, (added, removed) = _diff_both_ways(inst, [("delete", "arc", part)])
        assert set(st.modes.values()) == {"full"} and added is None
        cut += removed is not None
    assert cut                                          # some delete cut facts
    st, _ = _diff_both_ways(inst, [("insert", "arc", edges[:18])])
    assert set(st.modes.values()) == {"bitmatrix"}
    st, sides = _diff_both_ways(inst, [("delete", "arc", inst.relation("arc"))])
    assert sides[0] is None and sides[1][1] > 0 and inst.store[inst.strat.idb[0]].count == 0
    _diff_both_ways(inst, [("insert", "arc", edges)])

    # a complete digraph keeps every fact when one arc goes
    k6 = _complete(6)
    inst = MaterializedInstance(program, {"arc": k6}, cache=PlanCache(), device="cpu")
    st, sides = _diff_both_ways(inst, [("delete", "arc", k6[:1])])
    assert st.modes == {0: "full"} and sides == (None, None) and st.retracted == 0

    # restored from an engine checkpoint: the words come from PackedStratum.pack
    d = str(tmp_path / "ck")
    Engine(EngineConfig(backend="tuple", checkpoint_every=1, checkpoint_dir=d),
           device="cpu").run(program, {"arc": edges})
    inst = MaterializedInstance.restore(d, program=program, device="cpu")
    assert inst._bm
    for part in np.array_split(edges[-12:], 2):
        st, _ = _diff_both_ways(inst, [("delete", "arc", part)])
        assert set(st.modes.values()) == {"full"}


@pytest.mark.parametrize("prog", ["tc", "sg"])
def test_a_resident_stratums_table_holds_exactly_its_words(prog):
    """After every transaction the published IDB table of a resident PBME
    stratum is the table of its packed fixpoint's set bits, in rows, count
    and capacity.  A delete's word diff (``PackedStratum.diff``) rests on
    this: without this test nothing guards that diff against the tables."""
    program = {"tc": TC, "sg": SG}[prog]
    rng = np.random.default_rng(10)
    edges = random_edges(rng, 20, 50)
    inst = MaterializedInstance(program, {"arc": edges[:35]}, cache=PlanCache(),
                                device="cpu")
    (idx,) = inst._bm
    ops = [("insert", edges[35:]), ("delete", edges[:8]), ("insert", edges[:4]),
           ("delete", edges[30:45]), ("insert", edges[30:40]), ("delete", edges[:20])]
    for op, rows in ops:
        st = inst.apply_txn([(op, "arc", rows)])
        assert st.modes == {idx: "full" if op == "delete" else "bitmatrix"}
        table = inst.store[inst._bm[idx].plan.idb]
        got, count = bitmatrix_to_table(inst._bm[idx].m, inst.domain,
                                        inst.engine.config.capacity_min)
        assert (count, got.shape[0]) == (table.count, table.capacity)
        assert torch.equal(got, table.rows)


# --------------------------------------------------------------------------
# transactions (test_transactions)
# --------------------------------------------------------------------------


def _two_edb(rng, n=12, n_arc=26, n_rail=18):
    arc = np.unique(rng.integers(0, n, size=(n_arc, 2)), axis=0).astype(np.int32)
    rail = np.unique(rng.integers(0, n, size=(n_rail, 2)), axis=0).astype(np.int32)
    return arc, rail


def test_mixed_transactions(rng):
    arc, rail = _two_edb(rng)
    pair = Pair(TWO_EDB_TC, {"arc": arc[:-4], "rail": rail}, backend="tuple")
    st = pair.txn([("insert", "arc", arc[-4:-2]), ("delete", "rail", rail[-3:])])
    assert st.kind == "txn" and list(st.modes.values()).count("dred") == 1
    st = pair.txn([
        ("insert", "arc", arc[-2:]),
        ("insert", "arc", arc[-2:]),                      # duplicate: applied 0
        TxnOp("retract", "rail", rail[:2]),
    ])
    assert [o.applied for o in st.ops] == [2, 0, 2]
    st = pair.txn([("insert", "arc", arc[:2]), ("delete", "rail", np.array([[9, 9]]))])
    assert all(o.applied == 0 for o in st.ops)          # no-op: no epoch
    st = pair.txn([("insert", "arc", np.array([[0, 31]], np.int32)),
                   ("delete", "rail", rail[2:4])])
    assert st.full_rebuild


def test_transaction_validation_matches():
    arc, rail = _two_edb(np.random.default_rng(0))
    pair = Pair(TWO_EDB_TC, {"arc": arc, "rail": rail}, backend="tuple")
    bad = [
        [],
        [("upsert", "arc", arc[:1])],
        [("insert", "tc", arc[:1])],
        [("insert", "arc", arc[:2].astype(np.float32))],
        [("insert", "arc", np.zeros((2, 3), np.int32))],
        [("insert", "arc", np.array([[-1, 0]], np.int32))],
        [("insert", "arc", arc[:1]), ("delete", "arc", arc[:1])],
    ]
    for ops in bad:
        with pytest.raises((KeyError, ValueError)) as want:
            pair.ref.normalize_txn_ops(ops)
        with pytest.raises(type(want.value), match=None) as got:
            pair.port.normalize_txn_ops(ops)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# pinned snapshots (test_snapshot_reads)
# --------------------------------------------------------------------------


def test_pinned_snapshots_and_reclamation(rng):
    edges = random_edges(rng, 22, 60)
    for backend in ("tuple", "auto"):
        pair = Pair(TC, {"arc": edges[:40]}, backend=backend)
        ref_pin, port_pin = pair.ref.pin(), pair.port.pin()
        pair.insert("arc", edges[40:50])
        pair.delete("arc", edges[:5])
        pair.check(ref_pin, port_pin)                      # still epoch 0
        for src in range(0, 22, 5):
            np.testing.assert_array_equal(
                pair.port.query("tc", src=src, snapshot=port_pin),
                pair.ref.query("tc", src=src, snapshot=ref_pin),
            )
            np.testing.assert_array_equal(
                pair.port.query("tc", dst=(src, src + 3)),
                pair.ref.query("tc", dst=(src, src + 3)),
            )
        ref_pin.release()
        port_pin.release()
        assert pair.port.vstore.stats() == pair.ref.vstore.stats()


def test_dense_relation_queries(rng):
    edges = random_edges(rng, 24, 70)
    pair = Pair(WORKLOADS["cc"].program, {"arc": edges})
    for rel in pair.port.strat.idb:
        for bounds in ({"src": (2, 9)}, {"val": (0, 4)}, {"src": 3, "val": (0, 9)}):
            try:
                want = pair.ref.query(rel, **bounds)
            except IndexError:                  # a bound past the arity
                with pytest.raises(IndexError):
                    pair.port.query(rel, **bounds)
                continue
            np.testing.assert_array_equal(pair.port.query(rel, **bounds), want)
