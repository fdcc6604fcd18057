"""Scenario driver: replay an arrival trace against a ``DatalogServer``.

The driver owns both notions of time:

* **Virtual time** (:class:`~repro_torch.loadgen.clock.VirtualClock`) drives the
  server: arrivals land at their trace times, and each admission step costs
  a fixed ``service_cost`` of virtual seconds, so queue depth — and with it
  every shed and deadline verdict — is a pure function of the trace and the
  scenario's parameters.  Replaying one scenario twice produces identical
  accept/shed/deadline outcomes on any machine.
* **Wall time** measures what virtual time cannot: the *real* per-request
  sojourn (submission → result visible), which is the latency signal the
  benchmark trajectory tracks.  Wall latencies vary run to run; verdicts do
  not.

The exactness verdict is the harness's core guarantee: after a hostile run,
the server's final state must be **bit-for-bit** what a fresh instance
produces by serially applying exactly the transactions the server
acknowledged as applied, in submission order.  Shedding and deadline
enforcement may drop requests — they may never corrupt, reorder, or
silently lose an acknowledged one.

The workloads build ``repro_torch`` instances on their ``device``: CUDA
unless they are given ``device="cpu"``.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.graphs import gnp_graph
from repro_torch.obs.stats import percentile
from repro_torch.serve_datalog import (
    DatalogServer,
    DeadlineError,
    MaterializedInstance,
    OverloadError,
    RequestError,
    ServerLimits,
    UpdateStats,
)

from repro_torch.loadgen.arrivals import Arrival
from repro_torch.loadgen.clock import VirtualClock

TC_PROGRAM = """
tc(x, y) :- edge(x, y).
tc(x, y) :- tc(x, z), edge(z, y).
"""


class TcWorkload:
    """Transitive closure over a small graph: the default scenario workload.

    Deterministic by construction: the ops/query for arrival *i* are a pure
    function of ``(seed, i, arrival.key)``, so a serial replay of the
    accepted transactions reproduces the exact op payloads.

    Hot-key adversarial shape: consecutive transactions on one key
    alternate insert/retract of the *same* edge rows, which group-commit
    admission must refuse to coalesce — the merged transaction would both
    insert and retract a row — so storms degenerate to per-request
    application (the expensive path the harness wants under stress).
    """

    relations = ("edge", "tc")

    def __init__(
        self, n_nodes: int = 48, p: float = 0.04, seed: int = 0, config=None,
        device=None,
    ):
        self.n_nodes = n_nodes
        self.p = p
        self.seed = seed
        self.config = config        # EngineConfig; tests pass backend="tuple"
        self.device = device        # None: CUDA

    def build_instance(self) -> MaterializedInstance:
        # a spine path pins the domain at n_nodes, so scenario inserts
        # (always < n_nodes) never trigger domain-growth rebuilds
        spine = np.stack(
            [np.arange(self.n_nodes - 1), np.arange(1, self.n_nodes)], axis=1
        ).astype(np.int32)
        extra = gnp_graph(self.n_nodes, p=self.p, seed=self.seed)
        edges = np.unique(np.concatenate([spine, extra.astype(np.int32)]), axis=0)
        return MaterializedInstance(
            TC_PROGRAM, {"edge": edges}, self.config, device=self.device
        )

    def ops_for(self, arrival: Arrival, i: int) -> list[tuple]:
        """The transaction for arrival ``i`` — insert/retract pairs around
        ``arrival.key`` (even *i* inserts rows, odd *i* retracts the rows
        even ``i-1`` inserted: the group-commit-hostile pattern)."""
        n = self.n_nodes
        key = arrival.key % n
        pair = i // 2
        rows = np.array(
            [
                [key, (key + 1 + pair + j) % n]
                for j in range(max(arrival.size, 1))
            ],
            dtype=np.int32,
        )
        op = "insert" if i % 2 == 0 else "delete"
        return [(op, "edge", rows)]

    def query_for(self, arrival: Arrival, i: int) -> tuple[str, dict]:
        return "tc", {"src": arrival.key % self.n_nodes}


class CsdaWorkload:
    """CSDA program-analysis replay: stream held-out ``arc`` facts.

    Builds the CSDA null-pointer chain program over a prefix of a seeded
    fact set and replays the held-out ``arc`` rows in batches — arrival
    ``key`` is the batch index.  This is the deep-chain, many-iteration
    workload class (PAPER.md's program analyses) where each small batch
    still costs a long propagation, so deadlines bite mid-flight rather
    than in the queue.
    """

    relations = ("arc", "nullEdge", "null")

    def __init__(
        self, n_nodes: int = 400, warm_fraction: float = 0.7, seed: int = 0,
        n_batches: int = 32, config=None, device=None,
    ):
        self.config = config
        self.device = device        # None: CUDA
        from repro_torch.configs.datalog_workloads import ALL as _WORKLOADS
        from repro_torch.data.program_facts import csda_facts

        self.program = _WORKLOADS["csda"].program
        facts = csda_facts(n_nodes, seed=seed)
        arc = np.asarray(facts["arc"], np.int32)
        split = max(1, int(len(arc) * warm_fraction))
        self._warm = {
            "arc": arc[:split],
            "nullEdge": np.asarray(facts["nullEdge"], np.int32),
        }
        self._held = arc[split:]
        self._batches = np.array_split(
            self._held, max(min(n_batches, len(self._held)), 1)
        )
        self._max_node = int(arc.max()) if len(arc) else 0

    def build_instance(self) -> MaterializedInstance:
        # pin the domain with a self-loop on the max node so held-out facts
        # never trigger domain-growth rebuilds mid-scenario
        warm = dict(self._warm)
        pin = np.array([[self._max_node, self._max_node]], np.int32)
        warm["arc"] = np.unique(np.concatenate([warm["arc"], pin]), axis=0)
        return MaterializedInstance(
            self.program, warm, self.config, device=self.device
        )

    def ops_for(self, arrival: Arrival, i: int) -> list[tuple]:
        batch = self._batches[arrival.key % len(self._batches)]
        if len(batch) == 0:
            batch = self._warm["arc"][:1]      # degenerate split: re-insert
        return [("insert", "arc", np.asarray(batch, np.int32))]

    def query_for(self, arrival: Arrival, i: int) -> tuple[str, dict]:
        return "null", {"src": int(arrival.key) % (self._max_node + 1)}


@dataclass
class Scenario:
    """One named, fully seeded hostile-traffic scenario."""

    name: str
    arrivals: list[Arrival]
    limits: ServerLimits | None = None
    workload: object = field(default_factory=TcWorkload)
    #: virtual seconds one DatalogServer.step() costs — the service-rate
    #: model; arrivals faster than 1/service_cost build queue
    service_cost: float = 0.002
    default_deadline: float | None = None
    snapshot_reads: bool = True


@dataclass
class ScenarioResult:
    """What one scenario run produced — verdicts + latency percentiles."""

    name: str
    submitted: int = 0
    accepted: int = 0
    completed: int = 0
    applied_txns: int = 0
    shed: dict = field(default_factory=dict)           # kind -> count
    deadline_misses: dict = field(default_factory=dict)  # stage -> count
    errors: int = 0
    latency: dict = field(default_factory=dict)  # kind -> {p50, p99} wall secs
    queue_high_water: int = 0
    final_epoch: int = -1
    exact: bool = False
    mismatch: str | None = None

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())

    @property
    def shed_rate(self) -> float:
        return self.shed_total / self.submitted if self.submitted else 0.0

    def to_row(self) -> dict:
        """Flat JSON-friendly summary (benchmarks + CI gates read this)."""
        return {
            "name": self.name,
            "submitted": self.submitted,
            "accepted": self.accepted,
            "completed": self.completed,
            "applied_txns": self.applied_txns,
            "shed": dict(self.shed),
            "shed_rate": round(self.shed_rate, 6),
            "deadline_misses": dict(self.deadline_misses),
            "errors": self.errors,
            "latency": {
                k: {q: round(v, 6) for q, v in d.items()}
                for k, d in self.latency.items()
            },
            "queue_high_water": self.queue_high_water,
            "final_epoch": self.final_epoch,
            "exact": self.exact,
            "mismatch": self.mismatch,
        }


def _sorted_rows(rows: np.ndarray) -> np.ndarray:
    rows = np.asarray(rows)
    if rows.size == 0:
        return rows.reshape(0, rows.shape[1] if rows.ndim == 2 else 0)
    return rows[np.lexsort(rows.T[::-1])]


def check_exactness(
    workload, applied: list[tuple[int, list]], server_instance
) -> tuple[bool, str | None]:
    """Serial-replay verdict: fresh instance + the acknowledged txns, in
    rid order, must reproduce the server's final state bit-for-bit."""
    oracle = workload.build_instance()
    for _rid, ops in applied:
        oracle.apply_txn(ops)
    for rel in workload.relations:
        got = _sorted_rows(server_instance.relation(rel))
        want = _sorted_rows(oracle.relation(rel))
        if got.shape != want.shape or not np.array_equal(got, want):
            return False, (
                f"relation {rel!r}: server has {got.shape[0]} rows, "
                f"serial replay of {len(applied)} acknowledged txns "
                f"has {want.shape[0]}"
            )
    return True, None


def run_scenario(scenario: Scenario, device=None) -> ScenarioResult:
    """Replay one scenario; returns its :class:`ScenarioResult`.

    The loop interleaves service with arrivals on the virtual clock:
    between consecutive arrivals the server gets ``gap / service_cost``
    admission steps, so overload emerges (deterministically) whenever the
    trace's instantaneous rate beats the modeled service rate.
    ``device``, when given, is where the instances are built (a copy of the
    scenario's workload is moved there); otherwise the workload's own
    device, CUDA unless it says ``"cpu"``.
    """
    clock = VirtualClock()
    workload = scenario.workload
    if device is not None:
        workload = copy.copy(workload)
        workload.device = device
    inst = workload.build_instance()
    srv = DatalogServer(
        inst,
        snapshot_reads=scenario.snapshot_reads,
        limits=scenario.limits,
        clock=clock,
        history=len(scenario.arrivals) + 16,
    )
    res = ScenarioResult(name=scenario.name)
    pending: dict[int, tuple[float, str]] = {}   # rid -> (wall_submit, kind)
    sojourn: dict[str, list[float]] = {}
    txn_ops: dict[int, list] = {}

    def poll() -> None:
        if not pending:
            return
        wall = time.perf_counter()
        for rid in [r for r in pending if r in srv.done]:
            t0, kind = pending.pop(rid)
            sojourn.setdefault(kind, []).append(wall - t0)
            res.completed += 1
            out = srv.done[rid]
            if isinstance(out, DeadlineError):
                res.deadline_misses[out.stage] = (
                    res.deadline_misses.get(out.stage, 0) + 1
                )
            elif isinstance(out, RequestError):
                res.errors += 1
            elif isinstance(out, UpdateStats):
                res.applied_txns += 1

    def service_until(t: float) -> None:
        while clock() + scenario.service_cost <= t:
            if not srv.step():
                clock.advance_to(t)
                return
            clock.advance(scenario.service_cost)
            poll()
        clock.advance_to(t)

    for i, arrival in enumerate(scenario.arrivals):
        service_until(arrival.t)
        deadline = (
            arrival.deadline
            if arrival.deadline is not None
            else scenario.default_deadline
        )
        res.submitted += 1
        wall0 = time.perf_counter()
        try:
            if arrival.kind == "query":
                rel, kw = workload.query_for(arrival, i)
                rid = srv.submit_query(rel, deadline=deadline, **kw)
            else:
                ops = workload.ops_for(arrival, i)
                rid = srv.submit_txn(ops, deadline=deadline)
                txn_ops[rid] = ops
        except OverloadError:
            res.shed[arrival.kind] = res.shed.get(arrival.kind, 0) + 1
            continue
        except DeadlineError as e:
            res.deadline_misses[e.stage] = res.deadline_misses.get(e.stage, 0) + 1
            continue
        res.accepted += 1
        pending[rid] = (wall0, arrival.kind)

    # drain: every accepted request must resolve (the no-silent-drop law)
    while srv.step():
        clock.advance(scenario.service_cost)
        poll()
    srv.run()
    poll()
    if pending:
        res.mismatch = f"{len(pending)} accepted requests never resolved"

    res.queue_high_water = srv._queue_high_water
    res.final_epoch = inst.epoch
    if sojourn:
        sojourn["all"] = [v for vals in sojourn.values() for v in vals]
    res.latency = {
        kind: {
            "p50": percentile(vals, 0.50),
            "p99": percentile(vals, 0.99),
        }
        for kind, vals in sojourn.items()
    }
    applied = sorted(
        (rid, ops)
        for rid, ops in txn_ops.items()
        if isinstance(srv.done.get(rid), UpdateStats)
    )
    exact, mismatch = check_exactness(workload, applied, inst)
    res.exact = exact and res.mismatch is None
    res.mismatch = res.mismatch or mismatch
    srv.close()
    return res
