"""Durability on the port: ``repro_torch.persist`` and warm restore, on the CPU.

The scenarios of ``tests/test_persist.py``, run through ``repro_torch`` with
``device="cpu"``:

* ``repro_torch.persist.wal`` — CRC-framed append/replay, torn-tail
  tolerance, bit rot, epoch filtering, abort markers, atomic truncation
  under concurrent appends.
* ``repro_torch.persist.codec`` — snapshot round trip for all three relation
  kinds and packed PBME words, checksum validation, torn-tmp and
  corrupt-snapshot fallback.
* ``MaterializedInstance.restore`` — snapshot load + WAL-tail replay is bit
  for bit the pre-crash fixpoint across the crash points that matter.
* ``Engine._save_fixpoint``/``_load_fixpoint`` — mid-fixpoint checkpoints
  resume to the exact fixpoint.
* ``DatalogServer(durability=...)`` — WAL-before-publish, the background
  checkpointer's policy, reads during a checkpoint.

The cross-package checks (byte-identical blobs, roots restored in the other
package) are in ``tests/test_torch_persist_parity.py``.
"""

import json
import os
import shutil
import threading
import warnings

import numpy as np
import pytest
import torch

from conftest import adj_of, random_edges, tc_oracle
from repro_torch.configs.datalog_workloads import ALL as WORKLOADS
from repro_torch.core import Engine, EngineConfig
from repro_torch.core.relation import (
    DenseAggRelation,
    DenseSetRelation,
    TupleRelation,
    relation_from_blocks,
    relation_to_blocks,
)
from repro_torch.persist import (
    DeltaWAL,
    DurabilityConfig,
    SnapshotError,
    latest_valid_snapshot,
    list_snapshots,
    prune_snapshots,
    read_snapshot,
    write_snapshot,
)
from repro_torch.serve_datalog import DatalogServer, MaterializedInstance

CPU = "cpu"
TC = WORKLOADS["tc"].program
TC_SRC = "tc(x,y) :- arc(x,y).  tc(x,y) :- tc(x,z), arc(z,y)."
TUPLE = EngineConfig(backend="tuple")


@pytest.fixture(autouse=True)
def _quiet_shims():
    # the legacy submit_insert/submit_delete shims are the WAL's bare-record
    # path; their DeprecationWarning is expected here
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _as_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


def _assert_bit_for_bit(a: MaterializedInstance, b: MaterializedInstance):
    """Every relation of ``b`` equals ``a``'s exactly (sorted numpy rows)."""
    for rel in set(a.strat.edb) | set(a.strat.idb):
        ra, rb = a.relation(rel), b.relation(rel)
        assert np.array_equal(ra, rb), f"{rel}: {ra} != {rb}"


def _restore(root, **kw):
    return MaterializedInstance.restore(root, device=CPU, **kw)


# --------------------------------------------------------------------------
# Delta WAL
# --------------------------------------------------------------------------


def test_wal_append_replay_round_trip(tmp_path):
    wal = DeltaWAL(str(tmp_path / "wal.log"))
    r1 = np.array([[0, 1], [2, 3]], np.int32)
    r2 = np.array([[7, 8, 9]], np.int32)
    wal.append("arc", "insert", r1, epoch=1)
    wal.append("edge3", "delete", r2, epoch=2)
    wal.commit()
    recs = list(wal.replay())
    assert [(r.rel, r.op, r.epoch) for r in recs] == [
        ("arc", "insert", 1), ("edge3", "delete", 2)
    ]
    assert np.array_equal(recs[0].rows, r1)
    assert np.array_equal(recs[1].rows, r2)
    assert [r.epoch for r in wal.replay(after_epoch=1)] == [2]
    wal.close()


def test_wal_torn_tail_stops_replay(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = DeltaWAL(path)
    wal.append("arc", "insert", np.array([[0, 1]], np.int32), epoch=1)
    wal.append("arc", "insert", np.array([[1, 2]], np.int32), epoch=2)
    wal.close()
    with open(path, "r+b") as f:          # tear the second record mid-frame
        f.truncate(os.path.getsize(path) - 3)
    assert [r.epoch for r in DeltaWAL(path, fsync="off").replay()] == [1]


def test_wal_bit_rot_stops_replay(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = DeltaWAL(path)
    wal.append("arc", "insert", np.array([[0, 1]], np.int32), epoch=1)
    wal.append("arc", "insert", np.array([[1, 2]], np.int32), epoch=2)
    first_len = wal.size_bytes() // 2
    wal.close()
    with open(path, "r+b") as f:          # flip a payload byte in record 2
        f.seek(first_len + 30)
        b = f.read(1)
        f.seek(first_len + 30)
        f.write(bytes([b[0] ^ 0xFF]))
    assert [r.epoch for r in DeltaWAL(path, fsync="off").replay()] == [1]


def test_wal_truncate_never_drops_concurrent_appends(tmp_path):
    """A record fsynced during a concurrent truncate survives the swap."""
    wal = DeltaWAL(str(tmp_path / "wal.log"), fsync="off")
    n = 200
    stop = threading.Event()

    def truncator():
        while not stop.is_set():
            wal.truncate(up_to_epoch=0)

    th = threading.Thread(target=truncator)
    th.start()
    try:
        for e in range(1, n + 1):
            wal.append("arc", "insert", np.array([[e, e]], np.int32), epoch=e)
            wal.commit()
    finally:
        stop.set()
        th.join()
    assert [r.epoch for r in wal.replay()] == list(range(1, n + 1))
    wal.close()


def test_wal_abort_markers_cancel_failed_records(tmp_path):
    wal = DeltaWAL(str(tmp_path / "wal.log"), fsync="off")
    r1 = np.array([[0, 1]], np.int32)
    r2 = np.array([[1, 2]], np.int32)
    wal.append("arc", "insert", r1, epoch=1)
    wal.append("arc", "insert", r2, epoch=1)
    wal.append("arc", "insert", r1, epoch=1, abort=True)   # r1 acked failed
    assert [(r.epoch, r.rows.tolist()) for r in wal.replay()] == [(1, [[1, 2]])]
    wal.append("arc", "insert", r1, epoch=2)                # a retry that landed
    assert [r.epoch for r in wal.replay()] == [1, 2]
    wal.truncate(up_to_epoch=0)
    assert [(r.epoch, r.rows.tolist()) for r in wal.replay()] == [
        (1, [[1, 2]]), (2, [[0, 1]])
    ]
    # txn-granularity aborts drop a whole bracket
    token = wal.append_txn([("arc", "insert", r2), ("arc", "delete", r1)], 3)
    assert [t.epoch for t in wal.replay_txns()][-1] == 3
    wal.abort_txn(token, 3)
    assert 3 not in [t.epoch for t in wal.replay_txns()]
    wal.close()


def test_wal_truncate_drops_covered_epochs(tmp_path):
    wal = DeltaWAL(str(tmp_path / "wal.log"))
    for e in range(1, 6):
        wal.append("arc", "insert", np.array([[e, e + 1]], np.int32), epoch=e)
    assert wal.truncate(up_to_epoch=3) == 2
    assert [r.epoch for r in wal.replay()] == [4, 5]
    wal.append("arc", "delete", np.array([[9, 9]], np.int32), epoch=6)
    assert [r.epoch for r in wal.replay()] == [4, 5, 6]
    wal.close()


# --------------------------------------------------------------------------
# Snapshot codec
# --------------------------------------------------------------------------


def test_relation_blocks_round_trip_all_kinds():
    t = TupleRelation.from_numpy("t", np.array([[3, 1], [0, 2]], np.int32), 8, CPU)
    s = DenseSetRelation.empty("s", 70, CPU).update(
        torch.tensor([3, 64, 7]), torch.tensor([True, True, False])
    )
    a = DenseAggRelation.empty("a", 9, "MIN", CPU).update(
        torch.tensor([1, 5]), torch.tensor([4, 2]), torch.tensor([True, True])
    )
    for h in (t, s, a):
        meta, arrays = relation_to_blocks(h)
        back = relation_from_blocks(h.name, meta, arrays, CPU)
        assert type(back) is type(h) and back.count == h.count
        assert np.array_equal(back.to_numpy(), h.to_numpy())
    # dense Δ state survives (mid-fixpoint checkpoints resume from it)
    _, arrays = relation_to_blocks(s)
    s2 = relation_from_blocks("s", {"kind": "dense_set", "n": 70}, arrays, CPU)
    assert torch.equal(s2.delta, s.delta)
    with pytest.raises(ValueError, match="unknown relation kind"):
        relation_from_blocks("x", {"kind": "heap"}, {}, CPU)
    with pytest.raises(TypeError, match="not serializable"):
        relation_to_blocks(object())


def test_snapshot_write_read_round_trip(tmp_path):
    root = str(tmp_path)
    handles = {
        "arc": TupleRelation.from_numpy("arc", np.array([[0, 1], [1, 2]], np.int32), 4, CPU),
        "seen": DenseSetRelation.empty("seen", 4, CPU).update(
            torch.tensor([1, 2]), torch.tensor([True, True])
        ),
    }
    # packed words with bit 31 set: int32 tensors go to disk as uint32, same bits
    words = torch.tensor([[1, -2147483648], [-1, 4]], dtype=torch.int32)
    bm = {0: {"arc": words, "m": words.flip(0)}}
    path = write_snapshot(
        root, handles=handles, domain=4, epoch=7, fingerprint="fp",
        stratification_hash="sh", program_source="r(x) :- e(x).",
        bitmatrix=bm, extra_meta={"k": 1}, extra_arrays={"d": torch.arange(3)},
    )
    assert np.load(os.path.join(path, "bm.0.arc.npy")).dtype == np.uint32
    snap = read_snapshot(path, device=CPU)
    assert (snap.epoch, snap.domain) == (7, 4)
    assert (snap.fingerprint, snap.strat_hash) == ("fp", "sh")
    assert snap.program_source == "r(x) :- e(x)."
    assert _as_set(snap.handles["arc"].to_numpy()) == {(0, 1), (1, 2)}
    assert snap.handles["seen"].count == 2
    assert snap.bitmatrix[0]["arc"].dtype == torch.int32
    assert torch.equal(snap.bitmatrix[0]["m"], words.flip(0))
    assert snap.extra_meta["k"] == 1
    assert torch.equal(snap.extra_arrays["d"], torch.arange(3))
    # idempotent: re-writing the same epoch is a no-op, not an error
    assert write_snapshot(root, handles=handles, domain=4, epoch=7) == path


def test_corrupt_snapshot_falls_back_to_previous(tmp_path):
    root = str(tmp_path)
    h = {"arc": TupleRelation.from_numpy("arc", np.array([[0, 1]], np.int32), 2, CPU)}
    p1 = write_snapshot(root, handles=h, domain=2, epoch=1)
    p2 = write_snapshot(root, handles=h, domain=2, epoch=2)
    blob = next(f for f in os.listdir(p2) if f.endswith(".npy"))
    with open(os.path.join(p2, blob), "r+b") as f:   # bit-rot epoch 2
        f.seek(40)
        f.write(b"\xff\xff")
    with pytest.raises(SnapshotError):
        read_snapshot(p2, device=CPU)
    snap = latest_valid_snapshot(root, device=CPU)
    assert snap is not None and snap.epoch == 1 and snap.path == p1


def test_torn_tmp_dir_is_never_a_snapshot(tmp_path):
    root = str(tmp_path)
    h = {"arc": TupleRelation.from_numpy("arc", np.array([[0, 1]], np.int32), 2, CPU)}
    write_snapshot(root, handles=h, domain=2, epoch=3)
    torn = os.path.join(root, "snapshot-000000000009.tmp-12345")
    os.makedirs(torn)
    with open(os.path.join(torn, "rel.arc.rows.npy"), "wb") as f:
        f.write(b"partial")                           # crash mid-snapshot
    assert latest_valid_snapshot(root, device=CPU).epoch == 3
    prune_snapshots(root, keep=1)
    assert not os.path.exists(torn)                   # tmp debris is swept


def test_restored_tensors_outlive_the_pruned_directory(tmp_path):
    """Blocks are copied off the mapped files: pruning a snapshot leaves
    the handles read from it intact."""
    root = str(tmp_path)
    rows = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    h = {"arc": TupleRelation.from_numpy("arc", rows, 6, CPU)}
    write_snapshot(root, handles=h, domain=6, epoch=1)
    snap = latest_valid_snapshot(root, device=CPU)
    write_snapshot(root, handles=h, domain=6, epoch=2)
    assert prune_snapshots(root, keep=1) == 1 and not os.path.exists(snap.path)
    assert np.array_equal(snap.handles["arc"].to_numpy(), rows)


def test_reads_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: snapshots are read onto it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        latest_valid_snapshot("no-such-root")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MaterializedInstance.restore("no-such-root")


# --------------------------------------------------------------------------
# Crash injection through the serving stack
# --------------------------------------------------------------------------


def _durable_server(tmp_path, edges, **cfg_kw):
    inst = MaterializedInstance(TC_SRC, {"arc": edges}, TUPLE, device=CPU)
    cfg_kw.setdefault("checkpoint_every_epochs", 0)
    cfg_kw.setdefault("checkpoint_wal_bytes", 0)
    cfg = DurabilityConfig(root=str(tmp_path / "dur"), **cfg_kw)
    return inst, DatalogServer(inst, durability=cfg)


def test_restore_replays_wal_tail_bit_for_bit(rng, tmp_path):
    edges = random_edges(rng, 24, 60)
    inst, srv = _durable_server(tmp_path, edges[:-6])
    srv.submit_insert("arc", edges[-6:-3])
    srv.submit_delete("arc", edges[:2])
    srv.submit_insert("arc", edges[-3:])
    srv.run()
    srv.close()
    restored = _restore(str(tmp_path / "dur"))
    _assert_bit_for_bit(inst, restored)
    assert restored.epoch == inst.epoch   # epoch numbering continues
    assert restored.restore_stats["replayed_records"] == 3
    stats = restored.insert_facts("arc", edges[:1])
    assert stats.epoch == inst.epoch + 1


def test_crash_between_wal_append_and_publish(rng, tmp_path):
    """A record durable in the WAL whose epoch never published is redone."""
    edges = random_edges(rng, 24, 60)
    batch = edges[-4:]
    inst, srv = _durable_server(tmp_path, edges[:-4])
    srv.run()                              # baseline snapshot only
    srv.durability.log_group([("arc", "insert", batch)], inst.epoch + 1)
    srv.close()                            # crash: batch never applied
    restored = _restore(str(tmp_path / "dur"))
    oracle = MaterializedInstance(TC_SRC, {"arc": edges}, TUPLE, device=CPU)
    assert _as_set(restored.relation("arc")) == _as_set(oracle.relation("arc"))
    assert _as_set(restored.relation("tc")) == _as_set(oracle.relation("tc"))


def test_crash_mid_snapshot_recovers_from_previous_epoch(rng, tmp_path):
    """A torn/corrupt newest snapshot does not poison recovery: the WAL
    still covers the gap from the previous snapshot."""
    edges = random_edges(rng, 24, 60)
    inst, srv = _durable_server(tmp_path, edges[:-6])
    srv.submit_insert("arc", edges[-6:-3])
    srv.run()
    srv.submit_insert("arc", edges[-3:])
    srv.run()
    root = str(tmp_path / "dur")
    torn = os.path.join(root, "snapshot-000000000099.tmp-1")
    os.makedirs(torn)
    with open(os.path.join(torn, "MANIFEST.json"), "w") as f:
        f.write("{")                       # interrupted json
    newest = srv.checkpoint_now()
    blob = next(f for f in sorted(os.listdir(newest)) if f.endswith(".npy"))
    with open(os.path.join(newest, blob), "r+b") as f:
        f.seek(50)
        f.write(b"\x13\x37")
    srv.close()
    restored = _restore(root)
    _assert_bit_for_bit(inst, restored)
    assert restored.restore_stats["snapshot_epoch"] < inst.epoch


def test_transient_failure_is_not_redone_on_recovery(rng, tmp_path):
    """A batch acknowledged as failed stays failed after a crash."""
    edges = random_edges(rng, 24, 60)
    inst, srv = _durable_server(tmp_path, edges[:-4])
    srv.run()
    real = inst.insert_facts
    inst.insert_facts = lambda rel, rows: (_ for _ in ()).throw(
        RuntimeError("transient device failure")
    )
    try:
        srv.submit_insert("arc", edges[-4:])
        done = srv.run()
        assert all(type(v).__name__ == "RequestError" for v in done.values())
    finally:
        inst.insert_facts = real
    srv.close()
    restored = _restore(str(tmp_path / "dur"))
    _assert_bit_for_bit(inst, restored)


@pytest.mark.parametrize("framed", [True, False], ids=["txn", "bare_record"])
@pytest.mark.parametrize("error, skipped", [
    (torch.cuda.OutOfMemoryError, None),
    (RuntimeError, None),
    (ValueError, 1),
], ids=["cuda_oom", "kernel_error", "rejected"])
def test_replay_raises_device_faults_and_skips_rejections(
    rng, tmp_path, monkeypatch, framed, error, skipped
):
    """A committed record whose replay hits a device fault is not dropped:
    the fault leaves ``restore``.  One the instance rejects (it failed
    before the crash too, unacknowledged) is skipped, as in the reference."""
    edges = random_edges(rng, 24, 60)
    _, srv = _durable_server(tmp_path, edges[:-4])
    if framed:
        srv.submit_txn([("insert", "arc", edges[-4:])])
    else:
        srv.submit_insert("arc", edges[-4:])
    srv.run()
    srv.close()

    def failing(self, ops, *args, **kwargs):
        raise error("replay failed")

    monkeypatch.setattr(MaterializedInstance, "apply_txn", failing)
    if skipped is None:
        with pytest.raises(error, match="replay failed"):
            _restore(str(tmp_path / "dur"))
    else:
        stats = _restore(str(tmp_path / "dur")).restore_stats
        assert (stats["skipped_records"], stats["replayed_records"]) == (skipped, 0)


def test_restore_rejects_mismatched_program(rng, tmp_path):
    _, srv = _durable_server(tmp_path, random_edges(rng, 16, 30))
    srv.run()
    srv.close()
    with pytest.raises(SnapshotError, match="fingerprint"):
        _restore(str(tmp_path / "dur"), program="other(x,y) :- arc(x,y).")


def test_restore_rejects_mismatched_stratification(rng, tmp_path):
    _, srv = _durable_server(tmp_path, random_edges(rng, 16, 30))
    srv.run()
    srv.close()
    root = str(tmp_path / "dur")
    mpath = os.path.join(list_snapshots(root)[-1], "MANIFEST.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["strat_hash"] = "0000000000000000"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(SnapshotError, match="stratification"):
        _restore(root)


def test_restore_without_snapshot_raises(tmp_path):
    with pytest.raises(SnapshotError, match="no valid snapshot"):
        _restore(str(tmp_path / "empty"))


def test_fresh_instance_cannot_attach_to_used_root(rng, tmp_path):
    edges = random_edges(rng, 16, 30)
    inst, srv = _durable_server(tmp_path, edges[:-2])
    srv.submit_insert("arc", edges[-2:])
    srv.run()
    srv.checkpoint_now()                   # root now checkpointed at epoch 1
    srv.close()
    fresh = MaterializedInstance(TC_SRC, {"arc": edges[:-2]}, TUPLE, device=CPU)
    with pytest.raises(SnapshotError, match="restore"):
        DatalogServer(fresh, durability=str(tmp_path / "dur"))
    restored = _restore(str(tmp_path / "dur"))
    srv2 = DatalogServer(restored, durability=str(tmp_path / "dur"))
    srv2.submit_insert("arc", edges[:1])
    srv2.run()
    srv2.close()
    _assert_bit_for_bit(restored, _restore(str(tmp_path / "dur")))
    other = MaterializedInstance("p(x,y) :- arc(x,y).", {"arc": edges}, TUPLE, device=CPU)
    with pytest.raises(SnapshotError, match="different program"):
        DatalogServer(other, durability=str(tmp_path / "dur"))


def test_fresh_instance_cannot_attach_over_unreplayed_wal(rng, tmp_path):
    edges = random_edges(rng, 16, 30)
    inst, srv = _durable_server(tmp_path, edges[:-2])
    srv.submit_insert("arc", edges[-2:])   # logged at epoch 1, no checkpoint
    srv.run()
    srv.close()
    fresh = MaterializedInstance(TC_SRC, {"arc": edges[:-2]}, TUPLE, device=CPU)
    with pytest.raises(SnapshotError, match="unreplayed WAL"):
        DatalogServer(fresh, durability=str(tmp_path / "dur"))
    DatalogServer(_restore(str(tmp_path / "dur")), durability=str(tmp_path / "dur")).close()


# --------------------------------------------------------------------------
# Dense + PBME state through the full save/restore cycle
# --------------------------------------------------------------------------


def test_restore_dense_and_pbme_workloads(rng, tmp_path):
    # PBME-resident TC (auto backend) with the packed matrices on disk; n = 40
    # puts columns 32..39 in a second word, so bit 31 of the first is a column
    edges = random_edges(rng, 40, 160)
    inst = MaterializedInstance(TC, {"arc": edges[:-4]}, device=CPU)
    root = str(tmp_path / "pbme")
    srv = DatalogServer(inst, durability=DurabilityConfig(root=root, checkpoint_wal_bytes=0))
    srv.submit_txn([("insert", "arc", edges[-4:])])
    srv.run()
    srv.close()
    snap = latest_valid_snapshot(root, device=CPU)
    assert set(snap.bitmatrix[0]) == {"arc", "m"}
    base = _restore(root, replay=False)     # the snapshot's own matrices, installed
    assert torch.equal(base._bm[0].arc, snap.bitmatrix[0]["arc"])
    assert torch.equal(base._bm[0].m, snap.bitmatrix[0]["m"])
    restored = _restore(root)
    _assert_bit_for_bit(inst, restored)
    for a, b in ((inst._bm[0].arc, restored._bm[0].arc),
                 (inst._bm[0].m, restored._bm[0].m)):
        assert torch.equal(a, b)
    more = np.array([[0, 31], [31, 1], [32, 39]], np.int32)
    s1 = inst.apply_txn([("insert", "arc", more)])
    s2 = restored.apply_txn([("insert", "arc", more)])
    assert s1.modes == s2.modes == {0: "bitmatrix"}
    _assert_bit_for_bit(inst, restored)

    # dense-set (reach) and dense-agg (cc) handles round-trip exactly
    inst2 = MaterializedInstance(WORKLOADS["cc"].program, {"arc": edges}, device=CPU)
    root2 = str(tmp_path / "dense")
    srv2 = DatalogServer(inst2, durability=root2)
    srv2.run()
    srv2.close()
    _assert_bit_for_bit(inst2, _restore(root2))


def test_restore_repacks_when_the_snapshot_has_no_matrices(rng, tmp_path):
    """A root without the ``bm.*`` sidecar (an engine checkpoint) restores
    with the PBME matrices re-packed from the relations."""
    edges = random_edges(rng, 40, 160)
    d = str(tmp_path / "ck")
    Engine(EngineConfig(backend="tuple", checkpoint_every=1, checkpoint_dir=d),
           device=CPU).run(TC, {"arc": edges})
    restored = _restore(d, program=TC)
    live = MaterializedInstance(TC, {"arc": edges}, device=CPU)
    assert torch.equal(restored._bm[0].m, live._bm[0].m)
    assert _as_set(restored.relation("tc")) == _as_set(live.relation("tc"))


# --------------------------------------------------------------------------
# Engine mid-fixpoint checkpoints
# --------------------------------------------------------------------------


def _tc_expect(edges, n):
    return set(zip(*np.nonzero(tc_oracle(adj_of(edges, n)))))


def test_engine_checkpoint_is_codec_format_and_resumes_exactly(rng, tmp_path):
    n = 36
    edges = random_edges(rng, n, 80)
    expect = _tc_expect(edges, n)
    d = str(tmp_path)
    Engine(EngineConfig(backend="tuple", checkpoint_every=2, checkpoint_dir=d),
           device=CPU).run(TC, {"arc": edges})
    snaps = list_snapshots(d)
    assert snaps, "cadence hook wrote no snapshot"
    meta = read_snapshot(snaps[0], device=CPU).extra_meta
    assert meta.get("engine_checkpoint") and "iteration" in meta
    got = Engine(TUPLE, device=CPU).run(TC, {"arc": edges}, resume_from=d)["tc"]
    assert set(map(tuple, got.tolist())) == expect
    # resume from an older, genuinely mid-fixpoint checkpoint: the saved Δ
    # views drive the remaining iterations to the exact fixpoint
    for s in snaps[1:]:
        shutil.rmtree(s)
    assert read_snapshot(snaps[0], device=CPU).extra_meta["delta_counts"]
    got2 = Engine(TUPLE, device=CPU).run(TC, {"arc": edges}, resume_from=d)["tc"]
    assert set(map(tuple, got2.tolist())) == expect


def test_engine_checkpoint_dir_reuse_across_runs(rng, tmp_path):
    n = 30
    edges1 = random_edges(rng, n, 60)
    edges2 = random_edges(rng, n, 60)
    d = str(tmp_path)

    def cfg():
        return EngineConfig(backend="tuple", checkpoint_every=2, checkpoint_dir=d)

    Engine(cfg(), device=CPU).run(TC, {"arc": edges1})
    Engine(cfg(), device=CPU).run(TC, {"arc": edges2})     # same dir, new engine
    got = Engine(TUPLE, device=CPU).run(TC, {"arc": edges2}, resume_from=d)["tc"]
    assert set(map(tuple, got.tolist())) == _tc_expect(edges2, n)


def test_engine_resume_without_checkpoint_raises(tmp_path):
    with pytest.raises(SnapshotError, match="no valid fixpoint checkpoint"):
        Engine(TUPLE, device=CPU).run(TC, {"arc": np.array([[0, 1]], np.int32)},
                                      resume_from=str(tmp_path))


# --------------------------------------------------------------------------
# Background checkpointer
# --------------------------------------------------------------------------


def test_checkpointer_policy_fires_in_background(rng, tmp_path):
    edges = random_edges(rng, 24, 60)
    inst, srv = _durable_server(
        tmp_path, edges[:-6], checkpoint_every_epochs=2, poll_seconds=0.01
    )
    for i in range(6):
        srv.submit_insert("arc", edges[-6 + i : -5 + i if i < 5 else None])
        srv.run()
    deadline = 100
    while srv.durability.last_snapshot_epoch < 6 and deadline:
        threading.Event().wait(0.05)
        deadline -= 1
    assert srv.durability.last_snapshot_epoch >= 5, srv.durability_stats()
    assert not srv.checkpoint_errors
    stats = srv.durability_stats()
    assert stats["checkpoints"] >= 3 and stats["checkpoint_errors"] == 0
    assert srv.metrics()["datalog_checkpoints_total"] == stats["checkpoints"]
    tail = list(srv.durability.wal.replay(after_epoch=srv.durability.last_snapshot_epoch))
    assert len(tail) <= 1
    srv.close()
    _assert_bit_for_bit(inst, _restore(str(tmp_path / "dur")))


def test_reads_overlap_checkpoint(rng, tmp_path):
    """Queries served while a checkpoint writes observe consistent state."""
    edges = random_edges(rng, 32, 120)
    inst, srv = _durable_server(tmp_path, edges)
    srv.run()
    src = int(edges[0, 0])
    expect = _as_set(inst.query("tc", src=src))
    results: list = []

    def reader():
        for _ in range(20):
            results.append(_as_set(inst.query("tc", src=src)))

    t = threading.Thread(target=reader)
    t.start()
    srv.durability.last_snapshot_epoch = -1   # force a re-snapshot
    srv.checkpoint_now()
    t.join()
    assert all(r == expect for r in results)
    srv.close()


def test_server_without_durability_has_no_checkpoints():
    inst = MaterializedInstance(TC_SRC, {"arc": np.array([[0, 1]], np.int32)}, TUPLE,
                                device=CPU)
    srv = DatalogServer(inst)
    assert srv.durability_stats() == {}
    with pytest.raises(RuntimeError, match="without durability"):
        srv.checkpoint_now()
    srv.close()
    srv.close()                               # idempotent


@pytest.mark.parametrize("arr", [
    np.arange(10, dtype=np.int32).reshape(5, 2),
    np.arange(12, dtype=np.int32).reshape(6, 2)[::2],          # not contiguous
    np.full((3, 313), 0x80000001, np.uint32),                  # bit 31 set
    np.packbits(np.ones(70, bool)),
    np.zeros((0, 2), np.int32),
    np.arange(3),
], ids=["int32", "strided", "uint32", "packed_bits", "empty", "int64"])
def test_saved_blocks_are_np_save_bytes(arr, tmp_path, monkeypatch):
    """The codec writes in pieces (here of 8 bytes) and still produces
    ``np.save``'s file, byte for byte."""
    from repro_torch.persist import codec

    monkeypatch.setattr(codec, "WRITE_CHUNK_BYTES", 8)
    codec.save_npy(str(tmp_path / "a.npy"), arr)
    np.save(str(tmp_path / "b.npy"), arr)
    assert (tmp_path / "a.npy").read_bytes() == (tmp_path / "b.npy").read_bytes()
    np.testing.assert_array_equal(np.load(str(tmp_path / "a.npy")), arr)
