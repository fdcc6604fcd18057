"""Shared helpers for the parity tests between ``repro`` and ``repro_torch``.

Every comparison here is exact: the Datalog path is integer work, so the two
packages must agree bit for bit.  ``ring_lattice`` makes the halo GCN's
partitioned input for both packages.
"""

import numpy as np

from repro.configs.datalog_workloads import ALL as WORKLOADS
from repro.core import Engine as RefEngine
from repro.core import EngineConfig as RefConfig
from repro.serve_datalog import MaterializedInstance as RefInstance
from repro.serve_datalog import PlanCache as RefCache
from repro.serve_datalog import TxnOp as RefTxnOp
from repro_torch.core import Engine, EngineConfig
from repro_torch.serve_datalog import MaterializedInstance, PlanCache, TxnOp


def record_key(stats):
    """EvalStats without wall times: iterations, per-record counts, backends."""
    return (
        stats.iterations,
        [
            (r.stratum, r.iteration, r.idb, r.candidates, r.deduped, r.delta, r.full,
             r.dsd_strategy)
            for r in stats.records
        ],
        stats.backend_used,
    )


def assert_blocks_equal(ref_blocks, port_blocks):
    """``{name: (meta, arrays)}`` maps equal: same meta, byte-identical arrays."""
    assert ref_blocks.keys() == port_blocks.keys()
    for name, (meta, arrays) in ref_blocks.items():
        pmeta, parrays = port_blocks[name]
        assert meta == pmeta, name
        assert arrays.keys() == parrays.keys(), name
        for k, arr in arrays.items():
            arr, parr = np.asarray(arr), np.asarray(parrays[k])
            assert arr.dtype == parr.dtype and arr.shape == parr.shape, (name, k)
            assert arr.tobytes() == parr.tobytes(), (name, k)


def run_both(program, edb, **cfg):
    """Run both engines (the port on the CPU) with the same config fields."""
    ref = RefEngine(RefConfig(**cfg))
    ref_out = ref.run(program, edb)
    port = Engine(EngineConfig(**cfg), device="cpu")
    port_out = port.run(program, edb)
    return ref, ref_out, port, port_out


def assert_runs_equal(program, edb, **cfg):
    """Rows, EvalStats and every stored handle (rows with pads, counts,
    capacities) agree exactly."""
    ref, ref_out, port, port_out = run_both(program, edb, **cfg)
    assert ref_out.keys() == port_out.keys()
    for name, rows in ref_out.items():
        assert rows.dtype == port_out[name].dtype, name
        np.testing.assert_array_equal(rows, port_out[name], err_msg=name)
    assert record_key(ref.stats) == record_key(port.stats)
    assert_blocks_equal(
        {k: h.to_blocks() for k, h in ref.store.items()},
        {k: h.to_blocks() for k, h in port.store.items()},
    )
    return ref, port


# --------------------------------------------------------------------------
# the serving layer
# --------------------------------------------------------------------------

TC = WORKLOADS["tc"].program
SG = WORKLOADS["sg"].program
NEG_PROG = """
tc(x,y) :- arc(x,y).
tc(x,y) :- tc(x,z), arc(z,y).
node(x) :- arc(x,y).
node(y) :- arc(x,y).
ntc(x,y) :- node(x), node(y), !tc(x,y).
"""
TWO_EDB_TC = """
tc(x,y) :- arc(x,y).
tc(x,y) :- rail(x,y).
tc(x,y) :- tc(x,z), arc(z,y).
tc(x,y) :- tc(x,z), rail(z,y).
"""
SSSP_COPY = """
sssp2(y, MIN(0)) :- id(y).
sssp2(y, MIN(d1+d2)) :- sssp2(x,d1), arc(x,y,d2).
copy(x,d) :- sssp2(x,d).
"""


def stats_key(s):
    """Everything an ``UpdateStats`` says except its wall time."""
    return (
        s.relation, s.requested, s.kind, s.inserted, s.removed, s.derived,
        s.retracted, s.full_rebuild, s.epoch, s.modes, s.iterations,
        s.derived_by_stratum, [(o.op, o.rel, o.requested, o.applied) for o in s.ops],
        s.read_set, s.write_set,
    )


def blocks(handles):
    return {k: h.to_blocks() for k, h in handles.items()}


class ServePair:
    """The reference instance and the port's (on the CPU), kept in step."""

    def __init__(self, prog, edb, **cfg):
        self.ref = RefInstance(
            prog, edb, RefConfig(use_pallas_bitmm=False, **cfg), cache=RefCache()
        )
        self.port = MaterializedInstance(
            prog, edb, EngineConfig(**cfg), cache=PlanCache(), device="cpu"
        )
        self.check()

    def txn(self, ops):
        want = self.ref.apply_txn(
            [RefTxnOp(o.op, o.rel, o.rows) if isinstance(o, TxnOp) else o for o in ops]
        )
        got = self.port.apply_txn(ops)
        assert stats_key(got) == stats_key(want)
        self.check()
        return got

    def insert(self, rel, rows):
        return self.txn([("insert", rel, rows)])

    def delete(self, rel, rows):
        return self.txn([("delete", rel, rows)])

    def check(self, ref_snap=None, port_snap=None):
        assert self.port.epoch == self.ref.epoch
        assert self.port.domain == self.ref.domain
        names = sorted(set(self.ref.strat.edb) | set(self.ref.strat.idb))
        for name in names:
            want = self.ref.relation(name, snapshot=ref_snap)
            got = self.port.relation(name, snapshot=port_snap)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        ref_h = ref_snap.handles if ref_snap is not None else self.ref.store
        port_h = port_snap.handles if port_snap is not None else self.port.store
        assert_blocks_equal(blocks(ref_h), blocks(port_h))


def stratum_of(inst, pred):
    return next(s.index for s in inst.strat.strata if pred in s.preds)


def ring_lattice(n: int, width: int, shards: int, halo: int, e_loc: int, rng):
    """A ring lattice (each node's ``width`` successors and predecessors)
    cut into ``shards`` blocks, each block's edges locally indexed as
    ``forward_halo`` reads them (senders through the halo), -1 padded to
    ``e_loc``; node features and labels drawn from ``rng``."""
    n_loc = n // shards
    offsets = [o for o in range(-width, width + 1) if o]
    rcv_g = np.repeat(np.arange(n), len(offsets))
    snd_g = (rcv_g + np.tile(offsets, n)) % n
    senders, receivers = [], []
    for s in range(shards):
        lo = s * n_loc
        keep = (rcv_g >= lo) & (rcv_g < lo + n_loc)
        r, g = rcv_g[keep] - lo, snd_g[keep]
        rel = (g - lo) % n                    # position after this block's start, on the ring
        local = np.where(rel < n_loc, halo + rel,
                         np.where(rel >= n - halo, rel - (n - halo), halo + rel))
        assert ((rel < n_loc + halo) | (rel >= n - halo)).all()
        pad = np.full(e_loc - len(r), -1)
        senders.append(np.concatenate([local, pad]))
        receivers.append(np.concatenate([r, pad]))
    feats = rng.standard_normal((n, 12)).astype(np.float32)
    labels = rng.integers(-1, 5, size=n).astype(np.int32)
    return (feats, np.concatenate(senders).astype(np.int32),
            np.concatenate(receivers).astype(np.int32), labels)
