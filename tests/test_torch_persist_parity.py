"""Durability across the two packages: ``repro.persist`` against
``repro_torch.persist``.

The same serving history runs through the reference's ``DatalogServer`` and
the port's (on the CPU), each with a durability root:

* the snapshots are the same files — both manifests are equal, every
  blob's SHA-256 included (relation blocks with their padding, packed PBME
  words with bit 31 set, dense bit vectors);
* the WALs differ only in their transaction tokens (``uuid4``): both replay
  the same ``(op, rel, rows, epoch)`` transactions;
* a root written by either package restores in the other, bit for bit, with
  equal ``restore_stats``, and one more ``apply_txn`` on each side gives
  equal rows and ``UpdateStats``;
* an engine checkpoint directory written by either package is the same
  files and resumes in the other.

These are the only tests that import both packages' durability layers.
"""

import json
import os
import shutil

import numpy as np
import pytest

from repro.configs.datalog_workloads import ALL as WORKLOADS
from repro.core import Engine as RefEngine
from repro.core import EngineConfig as RefConfig
from repro.data.graphs import gnp_graph
from repro.data.program_facts import csda_facts
from repro.persist import DurabilityConfig as RefDurability
from repro.persist import SnapshotError as RefSnapshotError
from repro.persist import list_snapshots as ref_list_snapshots
from repro.persist.wal import DeltaWAL as RefWAL
from repro.serve_datalog import DatalogServer as RefServer
from repro.serve_datalog import MaterializedInstance as RefInstance
from repro.serve_datalog import PlanCache as RefCache
from repro_torch.core import Engine, EngineConfig
from repro_torch.persist import DurabilityConfig, SnapshotError, list_snapshots
from repro_torch.persist.wal import DeltaWAL
from repro_torch.serve_datalog import DatalogServer, MaterializedInstance, PlanCache
from torch_parity import blocks, assert_blocks_equal, record_key, stats_key

CPU = "cpu"
WAL = "wal.log"


def _manifest(snapshot_dir):
    with open(os.path.join(snapshot_dir, "MANIFEST.json")) as f:
        return json.load(f)


def _txns(wal):
    return [
        (t.token is None, t.epoch,
         [(r.op, r.rel, r.epoch, r.rows.dtype.str, r.rows.tolist()) for r in t.ops])
        for t in wal.replay_txns()
    ]


def _history(edges, n_tail):
    """Inserts and a delete before the checkpoint, a WAL tail after it."""
    k = max(len(edges) // 20, 1)
    held = edges[-(k * (n_tail + 2)):]
    base = edges[: -(k * (n_tail + 2))]
    before = [[("insert", "arc", held[:k])], [("delete", "arc", base[:k])]]
    tail = [[("insert", "arc", held[k * (i + 1): k * (i + 2)])] for i in range(n_tail)]
    tail.append([("insert", "arc", base[:k]), ("delete", "arc", base[k: 2 * k])])
    return base, before, tail


def _serve(server_cls, inst, durability, before, tail):
    srv = server_cls(inst, durability=durability)
    for ops in before:
        srv.submit_txn(ops)
        srv.run()
    path = srv.checkpoint_now()
    for ops in tail:
        srv.submit_txn(ops)
        srv.run()
    srv.close()
    return path


def _ref_instance(prog, edb, cfg):
    return RefInstance(prog, edb, RefConfig(use_pallas_bitmm=False, **cfg),
                       cache=RefCache())


def _port_instance(prog, edb, cfg):
    return MaterializedInstance(prog, edb, EngineConfig(**cfg), cache=PlanCache(),
                                device=CPU)


def _assert_same_state(ref, port):
    """Relations, stored handles (padding and capacities) and PBME words."""
    assert (port.epoch, port.domain) == (ref.epoch, ref.domain)
    for rel in sorted(set(ref.strat.edb) | set(ref.strat.idb)):
        np.testing.assert_array_equal(port.relation(rel), ref.relation(rel), err_msg=rel)
    assert_blocks_equal(blocks(ref.store), blocks(port.store))
    assert ref._bm.keys() == port._bm.keys()
    for idx, st in ref._bm.items():
        for f in ("arc", "m"):
            want = np.asarray(st[f])
            assert want.dtype == np.uint32
            got = getattr(port._bm[idx], f).numpy().view(np.uint32)
            np.testing.assert_array_equal(got, want, err_msg=f"bm {idx} {f}")


def _restore_both(root, cfg):
    ref = RefInstance.restore(root, config=RefConfig(use_pallas_bitmm=False, **cfg),
                              cache=RefCache())
    port = MaterializedInstance.restore(root, config=EngineConfig(**cfg),
                                        cache=PlanCache(), device=CPU)
    assert port.restore_stats == ref.restore_stats
    _assert_same_state(ref, port)
    return ref, port


# name → (program, EDB, engine config fields, tail transactions)
CASES = {
    # n = 80 > 32: bit 31 of the first packed word is a real column
    "tc_pbme": (WORKLOADS["tc"].program, {"arc": gnp_graph(80, p=0.03, seed=2)}, {}, 2),
    "sg_pbme": (WORKLOADS["sg"].program, {"arc": gnp_graph(72, p=0.03, seed=3)}, {}, 1),
    "cc_dense": (WORKLOADS["cc"].program, {"arc": gnp_graph(70, p=0.02, seed=4)}, {}, 1),
    "csda_tuple": (WORKLOADS["csda"].program, csda_facts(90, seed=0), {"backend": "tuple"}, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_history_same_files_and_cross_restore(case, tmp_path):
    prog, edb, cfg, n_tail = CASES[case]
    edb = {k: np.asarray(v, np.int32) for k, v in edb.items()}
    base, before, tail = _history(edb["arc"], n_tail)
    start = dict(edb, arc=base)
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    opts = dict(checkpoint_every_epochs=0, checkpoint_wal_bytes=0)
    ref_live = _ref_instance(prog, start, cfg)
    port_live = _port_instance(prog, start, cfg)
    ref_path = _serve(RefServer, ref_live, RefDurability(ref_root, **opts), before, tail)
    port_path = _serve(DatalogServer, port_live, DurabilityConfig(port_root, **opts),
                       before, tail)
    _assert_same_state(ref_live, port_live)
    if case.endswith("pbme"):
        assert port_live._bm and any(
            int(w) < 0 for w in port_live._bm[0].m.flatten())   # bit 31 set

    # the snapshots are the same files: equal manifests, every SHA-256 equal
    assert [os.path.basename(p) for p in list_snapshots(port_root)] == [
        os.path.basename(p) for p in ref_list_snapshots(ref_root)]
    assert os.path.basename(port_path) == os.path.basename(ref_path)
    for ref_snap, port_snap in zip(ref_list_snapshots(ref_root), list_snapshots(port_root)):
        ref_m, port_m = _manifest(ref_snap), _manifest(port_snap)
        assert port_m == ref_m
        assert sorted(os.listdir(port_snap)) == sorted(os.listdir(ref_snap))
    # the WALs: the same transactions, only the tokens differ
    ref_wal = RefWAL(os.path.join(ref_root, WAL), fsync="off")
    port_wal = DeltaWAL(os.path.join(port_root, WAL), fsync="off")
    # (truncated only up to the oldest retained snapshot, the baseline)
    assert _txns(port_wal) == _txns(ref_wal)
    assert len(_txns(ref_wal)) == len(before) + len(tail)
    ref_wal.close()
    port_wal.close()

    # each root restores in both packages, bit for bit and equal to the live state
    more = [("insert", "arc", base[-3:][:, ::-1].copy())]
    for root in (ref_root, port_root):
        ref, port = _restore_both(root, cfg)
        _assert_same_state(ref_live, port)
        assert stats_key(port.apply_txn(more)) == stats_key(ref.apply_txn(more))
        _assert_same_state(ref, port)


def test_rewritten_fingerprint_is_the_known_difference(tmp_path):
    """Once a known difference, now an equality: both packages admit through
    the analyzer's rewrites, so both manifests hold the rewritten program's
    fingerprint (``49712c469be1343d`` for TC with its base rule written
    twice), and ``restore(root, program=source)`` with the original source
    succeeds across packages both ways."""
    src = "tc(x,y) :- arc(x,y).\ntc(x,y) :- arc(x,y).\ntc(x,y) :- tc(x,z), arc(z,y)."
    edges = gnp_graph(40, p=0.05, seed=5).astype(np.int32)
    cfg = {"backend": "tuple"}
    ref = _ref_instance(src, {"arc": edges[:-3]}, cfg)
    port = _port_instance(src, {"arc": edges[:-3]}, cfg)
    assert port.plan.fingerprint == ref.plan.fingerprint == "49712c469be1343d"
    roots = {"reference": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    tail = [[("insert", "arc", edges[-3:])]]
    _serve(RefServer, ref, RefDurability(roots["reference"], checkpoint_wal_bytes=0),
           [], tail)
    _serve(DatalogServer, port, DurabilityConfig(roots["port"], checkpoint_wal_bytes=0),
           [], tail)
    manifests = {k: _manifest(ref_list_snapshots(root)[-1]) for k, root in roots.items()}
    assert manifests["port"]["fingerprint"] == manifests["reference"]["fingerprint"] == (
        "49712c469be1343d")
    assert manifests["port"] == manifests["reference"]
    for root in roots.values():
        got = MaterializedInstance.restore(root, program=src, config=EngineConfig(**cfg),
                                           cache=PlanCache(), device=CPU)
        want = RefInstance.restore(root, program=src, config=RefConfig(**cfg),
                                   cache=RefCache())
        assert got.plan.fingerprint == want.plan.fingerprint == ref.plan.fingerprint
        _assert_same_state(want, got)
        _assert_same_state(ref, got)


# (workload, backend, writer); the CSDA cases keep their ids, [reference] and [port]
CHECKPOINT_CASES = [
    pytest.param(wl, backend, writer,
                 id=writer if wl == "csda" else f"{wl}-{backend}-{writer}")
    for wl, backend in (("csda", "tuple"), ("tc", "tuple"), ("tc", "auto"),
                        ("sg", "tuple"), ("sg", "auto"))
    for writer in ("reference", "port")
]


def _checkpoint_edb(wl):
    if wl == "csda":
        return {k: np.asarray(v, np.int32) for k, v in csda_facts(120, seed=1).items()}
    return {"arc": gnp_graph(60, p=0.04, seed=3).astype(np.int32)}


@pytest.mark.parametrize("wl, backend, writer", CHECKPOINT_CASES)
def test_engine_checkpoints_same_files_and_resume_across(wl, backend, writer, tmp_path):
    """Checkpoints are written by the semi-naive loop: on the tuple path both
    packages write the same files and resume from each other's; a PBME
    stratum (``auto`` on TC and SG) runs the bit-matrix fixpoint, which
    checkpoints in neither package, so there is nothing to resume from."""
    prog = WORKLOADS[wl].program
    edb = _checkpoint_edb(wl)
    dirs = {"reference": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    ref = RefEngine(RefConfig(backend=backend, use_pallas_bitmm=False, checkpoint_every=3,
                              checkpoint_dir=dirs["reference"]))
    want = ref.run(prog, edb)
    port = Engine(EngineConfig(backend=backend, checkpoint_every=3,
                               checkpoint_dir=dirs["port"]), device=CPU)
    got = port.run(prog, edb)
    assert record_key(port.stats) == record_key(ref.stats)
    for rel in want:
        np.testing.assert_array_equal(got[rel], want[rel], err_msg=rel)
    snaps = list_snapshots(dirs[writer])
    assert [os.path.basename(p) for p in snaps] == [
        os.path.basename(p) for p in list_snapshots(dirs["port" if writer == "reference"
                                                         else "reference"])]
    for a, b in zip(list_snapshots(dirs["reference"]), list_snapshots(dirs["port"])):
        assert _manifest(b) == _manifest(a)
    if backend == "auto":
        assert set(ref.stats.backend_used.values()) == {"bitmatrix"} and snaps == []
        with pytest.raises(RefSnapshotError, match="no valid fixpoint checkpoint"):
            RefEngine(RefConfig(backend=backend)).run(prog, edb, resume_from=dirs[writer])
        with pytest.raises(SnapshotError, match="no valid fixpoint checkpoint"):
            Engine(EngineConfig(backend=backend), device=CPU).run(
                prog, edb, resume_from=dirs[writer])
        return
    # resume from the older, mid-fixpoint checkpoint (live Δ views on disk)
    assert len(snaps) >= 2
    for s in snaps[1:]:
        shutil.rmtree(s)
    assert _manifest(snaps[0])["extra_meta"]["delta_counts"]
    ref2 = RefEngine(RefConfig(backend="tuple"))
    ref_out = ref2.run(prog, edb, resume_from=dirs[writer])
    port2 = Engine(EngineConfig(backend="tuple"), device=CPU)
    port_out = port2.run(prog, edb, resume_from=dirs[writer])
    assert record_key(port2.stats) == record_key(ref2.stats)
    for rel in want:
        np.testing.assert_array_equal(port_out[rel], want[rel], err_msg=rel)
        np.testing.assert_array_equal(ref_out[rel], want[rel], err_msg=rel)
