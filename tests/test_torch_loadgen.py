"""The load generator on the port: ``repro_torch.loadgen`` against
``repro.loadgen``.

* The seeded arrival traces are the reference's, arrival for arrival.
* The virtual clock and ``wait_until`` keep their semantics.
* A scenario run through the port's server (``device="cpu"``) reaches the
  reference's verdicts for the same trace and seed: accepted, shed, deadline
  misses, applied transactions, final epoch, exactness.  The verdicts are
  compared with serialized reads (``snapshot_reads=False``): under MVCC
  reads whether a query overtakes the writer thread depends on the wall
  clock (``_pop_query_run`` asks whether the writer is alive), so the
  number of epochs can differ between two runs of either package; there
  the port is held to exactness and to resolving every accepted request.
* The deadline × WAL crash scenarios of ``tests/test_scenarios.py`` hold on
  the port: an expired transaction leaves no WAL residue, an inflight miss
  only an abort marker, and a crash while shedding restores exactly.
"""

import dataclasses
import threading

import numpy as np
import pytest

from conftest import random_edges
from repro.core import EngineConfig as RefConfig
from repro.loadgen import CsdaWorkload as RefCsdaWorkload
from repro.loadgen import Scenario as RefScenario
from repro.loadgen import TcWorkload as RefTcWorkload
from repro.loadgen import arrivals as ref_arrivals
from repro.loadgen import run_scenario as ref_run_scenario
from repro.serve_datalog import ServerLimits as RefLimits
from repro_torch.core import EngineConfig
from repro_torch.loadgen import (
    CsdaWorkload,
    Scenario,
    TcWorkload,
    VirtualClock,
    bursty_times,
    csda_replay_arrivals,
    hotkey_storm_arrivals,
    mixed_arrivals,
    poisson_times,
    run_scenario,
    wait_until,
)
from repro_torch.persist.wal import DeltaWAL
from repro_torch.serve_datalog import (
    DatalogServer,
    DeadlineError,
    DurabilityConfig,
    MaterializedInstance,
    OverloadError,
    ServerLimits,
    UpdateStats,
)

CPU = "cpu"
TC = """
tc(x,y) :- arc(x,y).
tc(x,y) :- tc(x,z), arc(z,y).
"""
TUPLE = EngineConfig(backend="tuple")


def _as_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


def _row(a, b):
    return np.array([[a, b]], np.int32)


# --------------------------------------------------------------------------
# seeded traces and the virtual clock
# --------------------------------------------------------------------------


def _fields(arrivals):
    return [dataclasses.astuple(a) for a in arrivals]


@pytest.mark.parametrize("make", [
    lambda m: m.poisson_times(40, 1.5, seed=4),
    lambda m: m.bursty_times(1.0, 50.0, period=0.5, duty=0.2, duration=2.0, seed=6),
    lambda m: _fields(m.mixed_arrivals(rate=50, duration=0.6, seed=9, n_keys=12,
                                       deadline=0.2)),
    lambda m: _fields(m.hotkey_storm_arrivals(rate=40, duration=0.6, hot_key=3, seed=23,
                                              n_keys=12)),
    lambda m: _fields(m.csda_replay_arrivals(12, 0.01, seed=2, query_every=3)),
], ids=["poisson", "bursty", "mixed", "hotkey_storm", "csda_replay"])
def test_traces_equal_the_reference(make):
    from repro_torch.loadgen import arrivals

    got, want = make(arrivals), make(ref_arrivals)
    assert got == want and len(got) > 0


def test_virtual_clock_semantics():
    clk = VirtualClock(start=5.0)
    assert clk() == 5.0 and clk.now() == 5.0
    assert clk.advance(1.5) == 6.5
    assert clk.advance_to(6.0) == 6.5       # time never moves backward
    clk.sleep(0.5)
    assert clk() == 7.0
    with pytest.raises(ValueError):
        clk.advance(-1.0)


def test_virtual_clock_is_thread_safe():
    clk = VirtualClock()
    stop = threading.Event()
    seen = []

    def reader():
        last = 0.0
        while not stop.is_set():
            now = clk()
            assert now >= last              # monotone under concurrent writes
            last = now
        seen.append(last)

    ts = [threading.Thread(target=reader) for _ in range(2)]
    for t in ts:
        t.start()
    for _ in range(2000):
        clk.advance(0.001)
    stop.set()
    for t in ts:
        t.join()
    assert all(s <= clk() for s in seen)


def test_wait_until_returns_final_truth():
    assert wait_until(lambda: True, timeout=0.1)
    assert not wait_until(lambda: False, timeout=0.05, interval=0.01)
    box = {"n": 0}

    def eventually():
        box["n"] += 1
        return box["n"] >= 3

    assert wait_until(eventually, timeout=5.0, interval=0.001)


def test_poisson_and_bursty_traces_are_seeded():
    assert poisson_times(10, 2.0, seed=4) == poisson_times(10, 2.0, seed=4)
    assert poisson_times(10, 2.0, seed=4) != poisson_times(10, 2.0, seed=5)
    bt = bursty_times(1.0, 50.0, period=0.5, duty=0.2, duration=2.0, seed=6)
    assert bt == bursty_times(1.0, 50.0, period=0.5, duty=0.2, duration=2.0, seed=6)
    assert bt == sorted(bt) and all(0 <= t < 2.0 for t in bt)


# --------------------------------------------------------------------------
# scenario verdicts: the port's server against the reference's
# --------------------------------------------------------------------------


def _verdicts(res):
    row = res.to_row()
    row.pop("latency")                      # wall clock: varies run to run
    return row


def _burst():
    times = bursty_times(0.5, 300.0, period=0.4, duty=0.25, duration=0.8, seed=21)
    return mixed_arrivals(rate=0, duration=0, times=times, seed=21, n_keys=12)


SCENARIOS = {
    # name → (arrivals, limits kwargs, service_cost, default_deadline)
    "burst": (_burst, dict(max_queue_depth=8, overload_policy="reject", degrade_at=0.75),
              0.01, None),
    "mixed": (lambda: mixed_arrivals(rate=50, duration=0.6, seed=9, n_keys=12),
              dict(max_queue_depth=4, degrade_at=0.75), 0.01, None),
    "storm": (lambda: hotkey_storm_arrivals(rate=40, duration=0.6, hot_key=3, seed=23,
                                            n_keys=12),
              dict(max_queue_depth=16), 0.005, None),
    "deadlines": (lambda: mixed_arrivals(rate=80, duration=0.5, seed=5, n_keys=12),
                  dict(max_queue_depth=32), 0.02, 0.05),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tc_scenario_verdicts_equal_the_reference(name):
    make, limits, cost, deadline = SCENARIOS[name]
    arrivals = make()
    port = run_scenario(Scenario(
        name, arrivals, limits=ServerLimits(**limits),
        workload=TcWorkload(n_nodes=12, p=0.1, seed=3, config=TUPLE),
        service_cost=cost, default_deadline=deadline, snapshot_reads=False), device=CPU)
    ref = ref_run_scenario(RefScenario(
        name, arrivals, limits=RefLimits(**limits),
        workload=RefTcWorkload(n_nodes=12, p=0.1, seed=3, config=RefConfig(backend="tuple")),
        service_cost=cost, default_deadline=deadline, snapshot_reads=False))
    assert port.exact, port.mismatch
    assert _verdicts(port) == _verdicts(ref)
    if name == "burst":
        assert port.shed_total > 0 and port.queue_high_water <= 8
    if name == "deadlines":
        assert sum(port.deadline_misses.values()) > 0


def test_burst_scenario_with_snapshot_reads_stays_exact():
    res = run_scenario(Scenario(
        "burst", _burst(), limits=ServerLimits(max_queue_depth=8, degrade_at=0.75),
        workload=TcWorkload(n_nodes=12, p=0.1, seed=3, config=TUPLE),
        service_cost=0.01), device=CPU)
    assert res.exact, res.mismatch
    assert res.shed_total > 0 and res.completed == res.accepted


def test_csda_scenario_verdicts_equal_the_reference():
    arrivals = csda_replay_arrivals(8, 0.004, seed=1, query_every=2)
    port = run_scenario(Scenario(
        "csda", arrivals, limits=ServerLimits(max_queue_depth=4),
        workload=CsdaWorkload(n_nodes=120, n_batches=8, config=TUPLE),
        service_cost=0.01, snapshot_reads=False), device=CPU)
    ref = ref_run_scenario(RefScenario(
        "csda", arrivals, limits=RefLimits(max_queue_depth=4),
        workload=RefCsdaWorkload(n_nodes=120, n_batches=8, config=RefConfig(backend="tuple")),
        service_cost=0.01, snapshot_reads=False))
    assert port.exact, port.mismatch
    assert _verdicts(port) == _verdicts(ref) and port.applied_txns > 0


def test_workloads_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the workloads build on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TcWorkload(n_nodes=8).build_instance()
    assert TcWorkload(n_nodes=8, device=CPU).build_instance().device.type == "cpu"


# --------------------------------------------------------------------------
# deadlines × WAL: expired txns never reach the log
# --------------------------------------------------------------------------


def _inst(rng, n=14, m=30):
    edges = random_edges(rng, n, m)
    return MaterializedInstance(TC, {"arc": edges}, TUPLE, device=CPU), edges


def _fresh_edge(edges, n=14):
    """An in-domain row not yet in ``edges`` (no no-op, no domain growth)."""
    have = _as_set(edges)
    return next(_row(a, b) for a in range(n) for b in range(n)
                if a != b and (a, b) not in have)


def _durable(inst, root, **kw):
    return DatalogServer(
        inst,
        durability=DurabilityConfig(root=str(root), checkpoint_every_epochs=0,
                                    checkpoint_wal_bytes=0),
        **kw,
    )


def _restore(root):
    return MaterializedInstance.restore(str(root), config=TUPLE, device=CPU)


def test_admission_expired_txn_never_reaches_wal(rng, tmp_path):
    inst, edges = _inst(rng)
    clk = VirtualClock()
    srv = _durable(inst, tmp_path, clock=clk)
    ok_row = _fresh_edge(edges)
    dead_row = _fresh_edge(np.concatenate([edges, ok_row]))
    ok = srv.submit_txn([("insert", "arc", ok_row)])
    dead = srv.submit_txn([("insert", "arc", dead_row)], deadline=0.5)
    clk.advance(1.0)                        # `dead` expires in the queue
    done = srv.run()
    assert isinstance(done[ok], UpdateStats)
    assert isinstance(done[dead], DeadlineError)
    wal_path = srv.durability.wal.path
    srv.close()
    logged = set()
    for rec in DeltaWAL(wal_path, fsync="off").replay():
        logged |= _as_set(rec.rows)
    assert tuple(ok_row[0]) in logged
    assert tuple(dead_row[0]) not in logged
    restored = _restore(tmp_path)
    assert tuple(dead_row[0]) not in _as_set(restored.relation("arc"))
    assert tuple(ok_row[0]) in _as_set(restored.relation("arc"))
    assert _as_set(restored.relation("tc")) == _as_set(inst.relation("tc"))


def test_inflight_expired_txn_leaves_only_abort_marker(rng, tmp_path, monkeypatch):
    inst, edges = _inst(rng)
    clk = VirtualClock()
    srv = _durable(inst, tmp_path, clock=clk)
    orig = inst._delta_stratum

    def slow(*a, **k):
        clk.advance(10.0)
        return orig(*a, **k)

    monkeypatch.setattr(inst, "_delta_stratum", slow)
    row = _fresh_edge(edges)
    rid = srv.submit_txn([("insert", "arc", row)], deadline=1.0)
    done = srv.run()
    assert isinstance(done[rid], DeadlineError)
    srv.close()
    restored = _restore(tmp_path)
    assert tuple(row[0]) not in _as_set(restored.relation("arc"))
    assert _as_set(restored.relation("tc")) == _as_set(inst.relation("tc"))


def test_crash_during_load_shedding_restores_cleanly(rng, tmp_path):
    """Crash (torn WAL tail) while the server sheds: the restore is exactly
    the acknowledged prefix, and the torn bracket drops whole."""
    inst, _ = _inst(rng)
    clk = VirtualClock()
    srv = _durable(inst, tmp_path, limits=ServerLimits(max_queue_depth=2), clock=clk)
    applied = []
    for i in range(6):
        try:
            rid = srv.submit_txn([("insert", "arc", _row(i, i + 20))])
            applied.append((rid, i))
        except OverloadError:
            pass
        if i % 3 == 2:
            srv.run()                       # drain between shedding waves
    done = srv.run()
    acked = [i for rid, i in applied if isinstance(done.get(rid), UpdateStats)]
    assert acked and len(acked) < 6         # some landed, some were shed
    wal = srv.durability.wal
    wal.begin_txn(inst.epoch + 1)           # crash mid-commit: no COMMIT frame
    wal.append("arc", "insert", _row(40, 41), inst.epoch + 1)
    pre_crash = {r: _as_set(inst.relation(r)) for r in ("arc", "tc")}
    srv.close()
    restored = _restore(tmp_path)
    for rel, want in pre_crash.items():
        assert _as_set(restored.relation(rel)) == want, rel
    assert (40, 41) not in _as_set(restored.relation("arc"))
