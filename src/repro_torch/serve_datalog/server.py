"""DatalogServer: a batched request loop over a MaterializedInstance.

The port of ``repro.serve_datalog.server`` (queue → admission batch →
serve → per-request stats), with these request kinds:

* *write transactions* — the primary write surface.  ``tx =
  srv.transaction(); tx.insert("edge", rows); tx.retract("owner", rows);
  rid = tx.submit()`` (or the one-shot :meth:`DatalogServer.submit_txn`)
  queues one atomic multi-relation mixed batch; it commits as exactly one
  store epoch with one WAL commit frame, and consecutive *compatible*
  transactions (no row inserted by one and retracted by another) coalesce
  into one group-commit epoch — one Δ/∇ propagation pass and one fsync for
  the whole group;
* *fact-insert / fact-delete batches* (deprecated ``submit_insert`` /
  ``submit_delete``) — the historical single-relation surface; consecutive
  same-kind same-relation requests still coalesce into one update call;
* *point/range queries* — answered against a pinned epoch snapshot through
  the plan cache's selection.

Concurrency (MVCC-lite, the default)
------------------------------------

Updates run on a single background *writer thread*; query batches never
queue behind them.  Each query batch pins the latest **published** epoch of
the instance's :class:`~repro_torch.core.versioned_store.VersionedStore` and reads
a consistent snapshot even while an update is mid-flight — one slow DRed
pass no longer stalls every reader.  The visibility contract is therefore
*snapshot consistency*, not strict submission order: a query observes every
update that **published** before the query batch pinned its epoch, and never
observes a half-applied batch.  Updates still apply in submission order
(there is exactly one in-flight writer), so once :meth:`DatalogServer.run`
returns, reads reflect every submitted update bit-for-bit.

Pass ``snapshot_reads=False`` for the legacy serialized loop: requests are
then served strictly in submission order (a query sees the effects of every
earlier update — read-your-writes at the cost of queueing behind them).

Device
------

The server runs on its instance's device.  The writer thread applies each
update on the instance's own CUDA stream, and every query batch waits on the
pinned epoch's event on its own stream, so reads never queue behind the
writer's kernels (see ``instance.py``).

With ``durability=`` (a root path, a ``DurabilityConfig`` or a
``DurabilityManager`` from ``repro_torch.persist``) every update is logged
to the WAL before its epoch publishes, and a checkpointer thread snapshots
the latest epoch off a reader pin, after waiting on its CUDA event.

Static analysis and demand: :meth:`DatalogServer.lint` and
``explain(adorn=...)`` run the analyzer (``repro_torch.analysis``) on the
host; ``submit_query(..., on_demand=True)`` answers a bound query from a
demand-specialized instance on the same device (an LRU of them, evicted when
the base publishes a new epoch), or falls back to the full materialization
with a coded ``DL4xx`` decision, counted in ``datalog_demand_fallbacks_total``.

Failure handling
----------------

Malformed transactions (empty, unknown relation, arity/dtype mismatch,
negative ids, a row both inserted and retracted) are rejected at
``tx.submit()``/``submit_txn`` time with a raised :class:`RequestError` —
before anything reaches the queue or the WAL.  The deprecated ``submit_*``
shims keep their historical exception types (``KeyError``/``ValueError``)
for shape problems and surface negative ids at apply time.  Failures that
only surface at apply time fall back to per-transaction application.  A
failed update publishes no epoch (MVCC rollback is "the epoch never
existed"), so the fallback can never double-apply — the guard that verifies
this checks the epoch counter, and refuses replay if a failed attempt
somehow left published state behind.
"""

from __future__ import annotations

import random
import threading
import time
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import (
    RATIO_BUCKETS,
    FixpointProfile,
    build_profile,
    device_memory_stats,
    misestimation_ratio,
)
from repro_torch.obs.stats import latency_summary
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.serve_datalog.errors import DeadlineError, OverloadError, RequestError
from repro_torch.serve_datalog.instance import MaterializedInstance, UpdateStats
from repro_torch.serve_datalog.limits import ServerLimits


@dataclass
class _Request:
    rid: int
    kind: str                    # "query" | "txn" | "insert" | "delete"
    rel: str
    payload: dict | np.ndarray | list
    submitted: float
    deadline: float | None = None    # absolute, on the server's clock
    profile: bool = False            # assemble a FixpointProfile on completion


# RequestError lives in errors.py (admission needs it without a module
# cycle); re-exported here for compatibility.
__all__ = [
    "DatalogServer",
    "DeadlineError",
    "OverloadError",
    "RequestError",
    "ServerLimits",
    "ServerStats",
    "ServerTransaction",
]


class ServerTransaction:
    """Accumulates the ops of one atomic multi-relation write transaction.

    ::

        tx = srv.transaction()
        tx.insert("edge", new_edges)
        tx.retract("owner", stale_owners)
        rid = tx.submit()          # validated here; one epoch when applied

    Ops accumulate client-side; nothing is queued until :meth:`submit`,
    which validates the whole transaction and enqueues it as one request.
    ``insert``/``retract`` return ``self`` for chaining.  It can be
    submitted once.
    """

    def __init__(self, server: "DatalogServer"):
        self._server = server
        self._ops: list[tuple[str, str, np.ndarray]] = []
        self._rid: int | None = None

    def insert(self, rel: str, rows) -> "ServerTransaction":
        self._check_open()
        self._ops.append(("insert", rel, rows))
        return self

    def retract(self, rel: str, rows) -> "ServerTransaction":
        self._check_open()
        self._ops.append(("delete", rel, rows))
        return self

    def _check_open(self) -> None:
        if self._rid is not None:
            raise RequestError(
                self._rid, "transaction already submitted; build a new one"
            )

    def submit(
        self, deadline: float | None = None, profile: bool = False
    ) -> int:
        """Validate and enqueue the transaction; returns its request id.

        ``deadline`` is seconds-from-now on the server's clock (see
        :meth:`DatalogServer.submit_txn`); ``profile=True`` captures the
        transaction's evaluation profile (:meth:`DatalogServer.profile`).
        """
        self._check_open()
        self._rid = self._server.submit_txn(
            self._ops, deadline=deadline, profile=profile
        )
        return self._rid


class _TxnRowSets:
    """Cumulative per-relation insert/retract row sets of one admission group.

    Group-commit compatibility: a candidate transaction may join the group
    only if the merged op list is still a valid transaction — no row
    inserted by one member and retracted by another — so coalescing never
    changes what sequential application would have produced.
    """

    _OPPOSITE = {"insert": "delete", "delete": "insert"}

    def __init__(self, ops):
        # kind → rel → accumulated row set, extended incrementally as
        # members are admitted — each candidate check is one set
        # intersection, so admitting B transactions stays linear in their
        # total row count rather than re-tupling prior members per check
        self._sets: dict[str, dict[str, set]] = {"insert": {}, "delete": {}}
        self.try_add(ops)       # a single valid txn can never self-conflict

    def try_add(self, ops) -> bool:
        """Admit ``ops`` into the group if compatible; False leaves the
        accumulated sets untouched."""
        staged = [(op, rel, set(map(tuple, rows.tolist()))) for op, rel, rows in ops]
        if any(
            s & self._sets[self._OPPOSITE[op]].get(rel, set())
            for op, rel, s in staged
        ):
            return False
        for op, rel, s in staged:
            self._sets[op].setdefault(rel, set()).update(s)
        return True


@dataclass
class RequestRecord:
    rid: int
    kind: str
    rel: str
    batch_size: int              # admission-batch size this request rode in
    queued_seconds: float
    service_seconds: float
    epoch: int = -1              # epoch read (queries) / published (updates)
    concurrent: bool = False     # query served while an update was in flight


@dataclass
class ServerStats:
    """Bounded per-request records + percentile helpers.

    ``latency(kind=..., concurrent=...)`` filters by request kind and — for
    queries — by whether the batch was served while a writer was in flight,
    which is how the serving benchmark separates idle-read latency from
    read-during-update latency.

    Concurrency: the serving loop appends through :meth:`add` and every
    read surface (``latency``, ``snapshot``, ``mvcc_stats``) copies the
    deque under the same lock — iterating a deque another thread is
    appending to raises ``RuntimeError`` mid-iteration, which is exactly
    what reader threads polling stats during a run used to hit.
    """

    # bounded: long-lived servers must not accumulate per-request state
    records: deque = field(default_factory=lambda: deque(maxlen=65536))
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(self, record: RequestRecord) -> None:
        with self._lock:
            self.records.append(record)

    def snapshot(self) -> list[RequestRecord]:
        """Copy-under-lock view — safe to iterate from any thread."""
        with self._lock:
            return list(self.records)

    def latency(
        self,
        kind: str | None = None,
        include_queue: bool = True,
        concurrent: bool | None = None,
    ) -> dict:
        return latency_summary(
            (r.queued_seconds if include_queue else 0.0) + r.service_seconds
            for r in self.snapshot()
            if (kind is None or r.kind == kind)
            and (concurrent is None or r.concurrent == concurrent)
        )


class DatalogServer:
    """Queue + admission batching over one materialized instance.

    ``snapshot_reads=True`` (default) is the MVCC mode described in the
    module docstring; ``snapshot_reads=False`` restores the legacy strictly
    serialized loop.  Either way there is at most one in-flight update.
    """

    def __init__(
        self,
        instance: MaterializedInstance,
        max_batch: int = 64,
        history: int = 4096,
        snapshot_reads: bool = True,
        durability=None,
        limits: ServerLimits | None = None,
        clock=None,
    ):
        self.instance = instance
        self.max_batch = max_batch
        self.history = history       # completed results retained for pickup
        self.snapshot_reads = snapshot_reads
        self.limits = limits
        # the clock every timestamp/deadline decision reads: a callable
        # returning seconds (default wall clock), or an object with .now()
        # — a loadgen VirtualClock makes scenario replays deterministic
        self._clock = (
            time.perf_counter if clock is None
            else clock if callable(clock) else clock.now
        )
        # sleeping (retry backoff) must advance the SAME notion of time: a
        # virtual clock advances, the wall clock blocks the thread
        self._sleep = getattr(clock, "sleep", time.sleep)
        self._retry_rng = random.Random(limits.retry_seed if limits else 0)
        self.queue: deque[_Request] = deque()
        self.done: dict[int, np.ndarray | UpdateStats | RequestError] = {}
        self.stats = ServerStats(
            records=deque(maxlen=limits.stats_records_cap if limits else 65536)
        )
        self._next_id = 0
        self._queue_high_water = 0
        # (thread, group, out, t0, base_epoch) of the one in-flight update
        self._writer: tuple | None = None
        # -- EXPLAIN/ANALYZE state --------------------------------------------
        # finished profiles by rid (bounded like ``done``), the slow-query
        # ring, and the demand-counted tracing scope: profiled requests need
        # spans, so submitting one turns the tracer on (without clearing)
        # and the last one in flight restores the caller's setting
        self._profiles: dict[int, FixpointProfile] = {}
        self._slow: deque[FixpointProfile] = deque(
            maxlen=limits.slow_query_log if limits else 64
        )
        self._profiling_inflight = 0
        self._trace_autoenabled = False
        # -- demand specialization (on_demand queries) ------------------------
        # LRU of demand-specialized instances keyed by (relation, binding
        # pattern); an entry whose instance is None is a *cached fallback*
        # (the transform fell back — DL4xx — so the pattern is not
        # re-analyzed per query).  base_epoch invalidates entries when the
        # base instance publishes a new epoch.
        self._demand_instances: "OrderedDict[tuple[str, str], dict]" = (
            OrderedDict()
        )
        self._demand_cap = limits.demand_instances if limits else 8
        self._demand_lock = threading.Lock()
        self._init_metrics()

        # -- durability (optional): WAL + background checkpointer -------------
        self.durability = None
        self._ckpt_thread: threading.Thread | None = None
        self._ckpt_stop = threading.Event()
        self._ckpt_wake = threading.Event()
        self.checkpoint_errors: list[str] = []
        self._ckpt_err_lock = threading.Lock()
        if durability is not None:
            from repro_torch.persist.manager import DurabilityManager

            self.durability = (
                durability
                if isinstance(durability, DurabilityManager)
                else DurabilityManager(durability)
            )
            # a WAL with no base snapshot cannot rebuild the instance — the
            # initial fixpoint is snapshotted once at attach time
            self.durability.ensure_baseline(instance)
            self._init_durability_metrics()
            self._ckpt_thread = threading.Thread(
                target=self._checkpoint_loop,
                name="datalog-checkpointer",
                daemon=True,
            )
            self._ckpt_thread.start()

    # -- metrics --------------------------------------------------------------

    def _init_metrics(self) -> None:
        """One registry unifying the server's scattered stat surfaces.

        Counters/histograms are updated on the serving and writer threads;
        gauges are callback-backed and read the live value at collection
        time, so the hot path pays nothing for them.
        """
        reg = self.metrics_registry = MetricsRegistry()
        self._m_requests = {
            kind: reg.counter(
                "datalog_requests_total", "Requests served, by kind",
                labels={"kind": kind},
            )
            for kind in ("query", "txn", "insert", "delete")
        }
        self._m_errors = reg.counter(
            "datalog_request_errors_total", "Requests that returned an error"
        )
        self._m_groups = reg.counter(
            "datalog_update_groups_total", "Coalesced update groups applied"
        )
        self._m_coalesced = reg.counter(
            "datalog_coalesced_requests_total",
            "Requests that rode in update groups",
        )
        self._m_inserted = reg.counter(
            "datalog_rows_inserted_total", "EDB rows inserted"
        )
        self._m_removed = reg.counter(
            "datalog_rows_removed_total", "EDB rows removed"
        )
        self._m_derived = reg.counter(
            "datalog_rows_derived_total", "IDB rows derived incrementally"
        )
        self._m_retracted = reg.counter(
            "datalog_rows_retracted_total", "IDB rows retracted (DRed)"
        )
        self._m_rebuilds = reg.counter(
            "datalog_full_rebuilds_total", "Domain-growth full rebuilds"
        )
        self._m_query_seconds = reg.histogram(
            "datalog_query_seconds", "Per-query service time (seconds)"
        )
        self._m_update_seconds = reg.histogram(
            "datalog_update_seconds", "Per-update-request service time (seconds)"
        )
        self._m_queue_wait = reg.histogram(
            "datalog_queue_wait_seconds", "Time from submit to admission"
        )
        # -- admission control (ServerLimits) ---------------------------------
        self._m_shed = {
            kind: reg.counter(
                "datalog_requests_shed_total",
                "Requests shed by admission control, by kind",
                labels={"kind": kind},
            )
            for kind in ("query", "txn", "insert", "delete")
        }
        self._m_deadline = {
            stage: reg.counter(
                "datalog_deadline_misses_total",
                "Requests failed past their deadline, by stage",
                labels={"stage": stage},
            )
            for stage in ("submit", "admission", "inflight")
        }
        self._m_retries = reg.counter(
            "datalog_update_retries_total",
            "Per-request fallback retries after transient writer failures",
        )
        reg.gauge(
            "datalog_queue_high_water",
            "Deepest the request queue has ever been",
            fn=lambda: self._queue_high_water,
        )
        vstore = self.instance.vstore
        cache = self.instance.cache
        reg.gauge("datalog_queue_depth", "Requests waiting for admission",
                  fn=lambda: len(self.queue))
        reg.gauge("datalog_reader_pins", "Snapshots currently pinned",
                  fn=vstore.active_pins)
        reg.gauge("datalog_epoch", "Latest published epoch",
                  fn=lambda: vstore.epoch)
        reg.gauge("datalog_live_epochs", "Epochs retained (latest + pinned)",
                  fn=lambda: vstore.stats()["live_epochs"])
        reg.gauge("datalog_domain", "Active-domain size",
                  fn=lambda: self.instance.domain)
        reg.gauge(
            "datalog_plan_cache_hit_rate", "Plan-cache hits / lookups",
            fn=lambda: (
                cache.hits / (cache.hits + cache.misses)
                if cache.hits + cache.misses else 0.0
            ),
        )
        reg.gauge("datalog_plan_cache_hits", "Plan-cache hits",
                  fn=lambda: cache.hits)
        reg.gauge("datalog_plan_cache_misses", "Plan-cache misses",
                  fn=lambda: cache.misses)
        reg.gauge("datalog_plan_cache_warmed_buckets",
                  "Pre-traced (fingerprint, bucket, arity, domain) combos",
                  fn=lambda: cache.stats()["warmed_buckets"])
        # -- EXPLAIN/ANALYZE (estimate-vs-actual feedback) --------------------
        self._m_misest = {
            level: reg.histogram(
                "datalog_misestimation_ratio",
                "Actual/estimated cardinality ratio ((a+1)/(e+1); 1 = perfect)",
                labels={"level": level},
                buckets=RATIO_BUCKETS,
            )
            for level in ("stratum", "query")
        }
        self._m_profiles = reg.counter(
            "datalog_profiles_total", "Requests profiled (profile=True)"
        )
        self._m_slow_queries = reg.counter(
            "datalog_slow_queries_total",
            "Requests captured by the slow-query log",
        )
        self._m_explain_requests = reg.counter(
            "datalog_explain_requests_total", "explain() calls served"
        )
        # -- demand specialization (on_demand query routing) ------------------
        self._m_demand_hits = reg.counter(
            "datalog_demand_hits_total",
            "on_demand queries served by a cached specialized instance",
        )
        self._m_demand_misses = reg.counter(
            "datalog_demand_misses_total",
            "on_demand queries that had to specialize (build or respecialize)",
        )
        self._m_demand_fallbacks = reg.counter(
            "datalog_demand_fallbacks_total",
            "on_demand queries served from the full materialization (DL4xx)",
        )
        self._m_demand_specialize = reg.histogram(
            "datalog_demand_specialize_seconds",
            "Demand transform + specialized-instance build time",
        )
        reg.gauge(
            "datalog_demand_instances",
            "Demand-specialized instances currently cached",
            fn=lambda: len(self._demand_instances),
        )
        # -- static analysis (admission diagnostics + lint traffic) ----------
        self._m_lint_requests = reg.counter(
            "datalog_lint_requests_total", "lint() calls served"
        )
        plan = self.instance.plan
        for severity in ("error", "warning", "info"):
            reg.gauge(
                "datalog_admission_diagnostics",
                "Diagnostics from this instance's admission analysis",
                labels={"severity": severity},
                fn=lambda s=severity: (
                    len(plan.report.by_severity(s)) if plan.report else 0
                ),
            )
        reg.gauge(
            "datalog_admission_rewrites",
            "Rewrites the analyzer applied at admission (DL3xx)",
            fn=lambda: (
                sum(1 for d in plan.report.diagnostics
                    if d.code.startswith("DL3"))
                if plan.report else 0
            ),
        )

    def _init_durability_metrics(self) -> None:
        reg = self.metrics_registry
        wal = self.durability.wal
        # the WAL / manager observe directly into these histogram sinks
        wal.fsync_histogram = reg.histogram(
            "datalog_wal_fsync_seconds", "WAL flush+fsync duration"
        )
        self.durability.checkpoint_histogram = reg.histogram(
            "datalog_checkpoint_seconds", "Checkpoint duration",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0, 60.0),
        )
        reg.gauge("datalog_wal_records", "Records appended to the WAL",
                  fn=lambda: wal.appended_records)
        reg.gauge("datalog_wal_syncs", "WAL fsync calls",
                  fn=lambda: wal.syncs)
        reg.gauge("datalog_wal_bytes", "WAL file size",
                  fn=wal.size_bytes)
        reg.gauge("datalog_checkpoints_total", "Checkpoints taken",
                  fn=lambda: self.durability._stats.checkpoints)
        reg.gauge("datalog_checkpoint_failures_total", "Checkpoints failed",
                  fn=lambda: self.durability._stats.checkpoint_failures)
        reg.gauge("datalog_last_checkpoint_epoch", "Epoch of newest snapshot",
                  fn=lambda: self.durability.last_snapshot_epoch)

    def metrics(self) -> dict:
        """JSON-serialisable snapshot of every server metric.

        The unified replacement for :meth:`mvcc_stats` and
        :meth:`durability_stats` — counters, callback gauges, and histogram
        buckets in one dict keyed by Prometheus-style metric names.
        """
        return self.metrics_registry.snapshot()

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of :meth:`metrics` (scrape-ready)."""
        return self.metrics_registry.to_prometheus()

    # -- static analysis ------------------------------------------------------

    def lint(self, source=None, *, outputs=None, config=None) -> list:
        """Lint a program (default: this instance's admitted program).

        Read-only and synchronous — never touches the queue, the WAL, or
        the store.  Returns the full coded diagnostic list (errors,
        warnings, infos — including the DL201 PBME-eligibility explainer);
        a broken candidate program produces error diagnostics here rather
        than raising, so clients can pre-flight programs before
        re-admission.  ``outputs`` enables reachability linting (DL103).
        """
        from repro_torch.analysis import DEFAULT_CONFIG, lint_program

        self._m_lint_requests.inc()
        with _TRACE.span("server.lint", "serve"):
            target = source if source is not None else self.instance.plan.program
            return lint_program(
                target,
                config if config is not None else DEFAULT_CONFIG,
                outputs=outputs,
            )

    # -- EXPLAIN / ANALYZE ----------------------------------------------------

    def explain(self, program=None, *, text: bool = False, adorn=None):
        """Static annotated plan tree with cost/cardinality estimates.

        Read-only and synchronous, like :meth:`lint` — never touches the
        queue, the WAL, or the store's write path.  With no ``program`` the
        instance's admitted plan is explained against its *current* state
        (EDB actual sizes seed the estimates; stored IDB counts ride along
        as ``actuals``).  A candidate ``program`` (source text or
        :class:`~repro_torch.core.ast.Program`) is admitted through the plan
        cache and explained with this instance's EDB sizes where relation
        names match — a pre-flight "what would this cost here".

        Returns a :class:`repro_torch.obs.explain.PlanEstimate` (``.to_json()``
        for the machine form); ``text=True`` returns the rendered tree.

        ``adorn="pred^bf"`` (or ``adorn=("pred", "bf")``) explains the
        *demand-specialized* plan instead: the program (candidate or
        admitted) is adorned and magic-rewritten for that binding pattern
        through the shared plan cache, and the estimate covers the
        transformed program with a unit-sized seed.  Returns
        ``(DemandTransform, PlanEstimate)`` — or, with ``text=True``, the
        rendered adorned program followed by the estimate tree.  A fallen-
        back transform explains the unspecialized plan (its ``DL4xx``
        diagnostic says why); an unknown predicate or malformed pattern is
        a usage error (:class:`RequestError`).
        """
        self._m_explain_requests.inc()
        with _TRACE.span("server.explain", "serve"):
            if adorn is not None:
                pred, pattern = (
                    adorn.split("^", 1) if isinstance(adorn, str) else adorn
                )
                base = (
                    self.instance.plan if program is None
                    else self.instance.cache.get(program)
                )
                handles = self.instance.vstore.handles
                sizes = {
                    name: float(getattr(handles.get(name), "count", 0))
                    for name in base.strat.edb
                }
                domain = self.instance.vstore.domain
                try:
                    plan, transform = self.instance.cache.get_demand(
                        base.program, pred, pattern,
                        sizes=sizes, domain=domain,
                    )
                except ValueError as e:
                    raise RequestError(-1, f"invalid adornment: {e}") from e
                sizes[transform.seed_rel] = 1.0
                est = plan.explain(sizes=sizes, domain=domain)
                if text:
                    return transform.render() + "\n" + est.render_text()
                return transform, est
            if program is None:
                est = self.instance.explain()
            else:
                plan = self.instance.cache.get(program)
                handles = self.instance.vstore.handles
                sizes = {
                    name: float(getattr(handles.get(name), "count", 0))
                    for name in plan.strat.edb
                }
                est = plan.explain(
                    sizes=sizes, domain=self.instance.vstore.domain
                )
        return est.render_text() if text else est

    def profile(self, rid: int, *, text: bool = False):
        """The :class:`~repro_torch.obs.profile.FixpointProfile` of a finished
        request submitted with ``profile=True``.

        Raises ``KeyError`` for unknown rids and for requests that were not
        profiled (or whose profile was evicted — the store is bounded by
        ``history``, like ``done``).  ``text=True`` returns the rendered
        tree instead of the object.
        """
        prof = self._profiles.get(rid)
        if prof is None:
            raise KeyError(
                f"no profile for rid {rid}: not submitted with profile=True, "
                "not finished, or evicted"
            )
        return prof.render_text() if text else prof

    def slow_queries(self) -> list:
        """The slow-query ring, oldest first: full profiles of requests
        whose sojourn exceeded ``ServerLimits.slow_query_threshold``
        (bounded by ``slow_query_log``; empty when no threshold is set)."""
        return list(self._slow)

    # -- submission ----------------------------------------------------------

    def now(self) -> float:
        """Current time on the server's clock (deadlines are relative to it)."""
        return self._clock()

    def _profile_on(self) -> None:
        """One more profiled request in flight; tracing must be live.

        While tracing is already on (a caller's trace, or other profiled
        requests in flight) the buffer is left alone so concurrent
        requests' spans survive; only the off→on transition clears.
        :meth:`_profile_off` restores the caller's setting once nothing
        profiled is in flight.
        """
        self._profiling_inflight += 1
        if not _TRACE.enabled:
            # tracing was off, so anything in the buffer is a stale trace
            # — drop it, or an old request's markers would alias this one's
            # rid (rids restart at 0 per server)
            _TRACE.clear()
            _TRACE.enabled = True
            self._trace_autoenabled = True

    def _profile_off(self) -> None:
        self._profiling_inflight = max(0, self._profiling_inflight - 1)
        if self._profiling_inflight == 0 and self._trace_autoenabled:
            _TRACE.enabled = False
            self._trace_autoenabled = False

    def _enqueue(
        self,
        kind: str,
        rel: str,
        payload,
        deadline: float | None,
        profile: bool = False,
    ) -> int:
        """The one admission gate every submission goes through.

        Resolves the request's absolute deadline (explicit ``deadline=``
        seconds-from-now, else the limits' ``default_deadline``), applies
        the overload policy when the queue is at its bound (``reject`` →
        :class:`OverloadError`; ``block`` → cooperatively drain admission
        groups until there is room), and — in graceful degradation —
        sheds *query* load at the lower ``degrade_at`` watermark while
        updates still fill the remaining headroom.  Without ``limits`` this
        is exactly the historical unbounded enqueue.
        """
        submitted = self._clock()
        abs_deadline: float | None = None
        lim = self.limits
        # a configured slow-query threshold auto-profiles every request —
        # the capture needs the span tree to already exist when the sojourn
        # turns out slow (an explicit opt-in cost, documented on ServerLimits)
        if lim is not None and lim.slow_query_threshold is not None:
            profile = True
        rel_deadline = (
            deadline if deadline is not None
            else (lim.default_deadline if lim else None)
        )
        if rel_deadline is not None:
            abs_deadline = submitted + rel_deadline
        rid = self._next_id
        self._next_id += 1
        if abs_deadline is not None and rel_deadline <= 0:
            # already dead on arrival: fail at the submitter, queue nothing
            self._m_deadline["submit"].inc()
            _TRACE.instant("deadline.miss", "serve", rid=rid, stage="submit")
            raise DeadlineError(
                rid, f"deadline expired {-rel_deadline:.6f}s before submission",
                stage="submit",
            )
        if lim is not None and lim.max_queue_depth is not None:
            # queries shed at the degradation watermark; updates at the bound
            bound = (
                lim.degrade_depth if kind == "query" else lim.max_queue_depth
            )
            if len(self.queue) >= bound:
                if lim.overload_policy == "reject":
                    self._m_shed[kind].inc()
                    _TRACE.instant(
                        "shed", "serve", rid=rid, kind=kind,
                        queue_depth=len(self.queue),
                    )
                    raise OverloadError(
                        rid,
                        f"queue at {len(self.queue)}/{bound} ({kind} bound); "
                        "overload policy is reject",
                    )
                # backpressure: the submitter drains the server's own queue
                # until there is room — a fast producer pays for the backlog
                # it created instead of growing it
                while len(self.queue) >= bound and self.step():
                    pass
        if profile:
            self._profile_on()
        self.queue.append(
            _Request(rid, kind, rel, payload, submitted, abs_deadline, profile)
        )
        self._queue_high_water = max(self._queue_high_water, len(self.queue))
        _TRACE.instant("enqueue", "serve", rid=rid, kind=kind, rel=rel)
        return rid

    def submit_query(
        self,
        rel: str,
        *,
        where: dict | None = None,
        deadline: float | None = None,
        profile: bool = False,
        on_demand: bool = False,
        **kw,
    ) -> int:
        """Queue one point/range query.

        ``deadline`` is seconds-from-now on the server's clock: a query
        still queued past it is failed cheaply (a :class:`DeadlineError` in
        ``done``) without touching the store.  ``profile=True`` captures
        the request's full span tree and estimate-vs-actual cardinalities;
        fetch the result with :meth:`profile` after it completes.

        ``on_demand=True`` routes a *bound* query (point constants on one
        or more columns of an IDB relation) through a demand-specialized
        instance: the program is adorned and magic-rewritten for the
        query's binding pattern and only the demanded slice is
        materialized, incrementally extended per new binding.  Results are
        bit-for-bit what the ordinary path returns.  Patterns that cannot
        specialize (coded ``DL4xx`` decision: no point bounds, non-IDB
        target, unstratifiable/unprofitable transform) silently fall back
        to the full materialization — never a request error — counted in
        ``datalog_demand_fallbacks_total``.  See ``docs/serving_api.md``.
        """
        return self._enqueue(
            "query", rel,
            {"where": where, "kw": kw, "on_demand": on_demand},
            deadline, profile,
        )

    def transaction(self) -> ServerTransaction:
        """A new :class:`ServerTransaction` for one atomic write transaction."""
        return ServerTransaction(self)

    def submit_txn(
        self, ops, deadline: float | None = None, profile: bool = False
    ) -> int:
        """Queue one transaction (iterable of ``(op, rel, rows)``/``TxnOp``).

        The whole transaction is validated here — empty transactions,
        unknown/non-EDB relations, arity or dtype mismatches, negative ids,
        and rows both inserted and retracted by the same transaction all
        raise :class:`RequestError` before anything reaches the queue or
        the WAL.  When applied, the transaction commits as exactly one
        epoch; its result in ``done`` is one ``UpdateStats`` with per-op
        slices.

        ``deadline`` is seconds-from-now on the server's clock.  A
        transaction still queued past it is failed *before* it is
        WAL-logged (recovery can never replay it); a transaction whose
        propagation pass crosses it between strata aborts and publishes
        nothing.
        """
        try:
            norm = self.instance.normalize_txn_ops(ops)
        except (KeyError, ValueError, TypeError) as e:
            # KeyError reprs its message in quotes — unwrap via args
            msg = e.args[0] if e.args else str(e)
            raise RequestError(-1, f"invalid transaction: {msg}") from e
        rels = "+".join(dict.fromkeys(rel for _, rel, _ in norm))
        return self._enqueue("txn", rels, norm, deadline, profile)

    def submit_insert(self, rel: str, rows: np.ndarray) -> int:
        """Deprecated: queue one single-relation insert (use transactions).

        Bit-for-bit the historical behavior — same validation exceptions,
        same coalescing, same stats — via the legacy request kind.
        """
        warnings.warn(
            "DatalogServer.submit_insert is deprecated; use "
            'transaction().insert(rel, rows).submit() or submit_txn',
            DeprecationWarning,
            stacklevel=2,
        )
        return self._submit_update("insert", rel, rows)

    def submit_delete(self, rel: str, rows: np.ndarray) -> int:
        """Deprecated: queue one single-relation delete (use transactions)."""
        warnings.warn(
            "DatalogServer.submit_delete is deprecated; use "
            'transaction().retract(rel, rows).submit() or submit_txn',
            DeprecationWarning,
            stacklevel=2,
        )
        return self._submit_update("delete", rel, rows)

    def _submit_update(self, kind: str, rel: str, rows: np.ndarray) -> int:
        """Admission-time validation: a malformed payload fails HERE, at its
        submitter, instead of poisoning the coalesced batch it would ride in
        (the bare ``np.concatenate`` in the serving loop needs every payload
        already shaped ``(k, arity)``)."""
        if rel not in self.instance.strat.edb:
            raise KeyError(f"{rel!r} is not an EDB relation of this program")
        arity = self.instance.plan.program.arity_of(rel)
        rows = np.asarray(rows, np.int32)
        # an nd payload must already have arity columns: reshape alone would
        # silently scramble e.g. 2 three-column rows into 3 two-column tuples
        # whenever the total size happens to divide
        bad_shape = rows.ndim >= 2 and rows.size and rows.shape[-1] != arity
        try:
            if bad_shape:
                raise ValueError("column count mismatch")
            rows = rows.reshape(-1, arity) if rows.size else rows.reshape(0, arity)
        except ValueError as e:
            raise ValueError(
                f"payload of shape {rows.shape} does not match "
                f"{rel!r} arity {arity}"
            ) from e
        # legacy requests ride the same admission gate (queue bound, default
        # deadline at admission); in-flight deadline checks are txn-only
        return self._enqueue(kind, rel, rows, None)

    # -- the serving loop ----------------------------------------------------

    _UPDATE_FNS = {"insert": "insert_facts", "delete": "retract_facts"}
    _UPDATE_KINDS = frozenset({"insert", "delete", "txn"})

    def run(self) -> dict[int, np.ndarray | UpdateStats | RequestError]:
        """Drain the queue; returns rid → query rows, UpdateStats, or
        RequestError.

        Update batches run on the writer thread (one at a time, in
        submission order); query batches are served immediately against a
        pinned snapshot of the latest published epoch.  Failures are
        isolated per request: a bad update in a coalesced batch falls back
        to per-request application so its valid neighbors still land, and
        never stalls the requests behind it.  On return every submitted
        update has published (or failed) — subsequent reads see the final
        fixpoint.
        """
        while self.step():
            pass
        self._reap_writer()
        return self.done

    def step(self) -> bool:
        """Serve at most one admission group; True while work remains.

        One iteration of :meth:`run`'s loop, exposed so a load generator
        (``repro_torch.loadgen``) can interleave arrivals with service — and so
        the ``block`` overload policy can drain cooperatively from inside a
        blocked submission.  Semantics are identical to :meth:`run`:
        calling ``step()`` until it returns False is exactly one ``run()``.
        """
        if not self.queue and self._writer is None:
            return False
        if self.snapshot_reads:
            qgroup = self._pop_query_run()
            if qgroup:
                # MVCC read path: never wait on the in-flight writer
                self._serve_queries(qgroup)
                return bool(self.queue or self._writer is not None)
        if not self.queue:
            self._reap_writer()
            return bool(self.queue or self._writer is not None)
        # updates serialize behind the in-flight writer (and in legacy
        # mode, queries do too)
        self._reap_writer()
        group = self._admit()
        if group[0].kind not in self._UPDATE_KINDS:
            self._serve_queries(group)
            return bool(self.queue or self._writer is not None)
        # deadline check at admission: an expired update is failed cheaply
        # HERE — before the writer, before the WAL — so recovery can never
        # replay a request whose submitter was told it timed out
        group = self._expire(group)
        if not group:
            return bool(self.queue or self._writer is not None)
        if self.snapshot_reads:
            self._start_writer(group)
        else:
            # legacy mode: apply inline — a thread would be join()ed
            # immediately anyway
            t0 = self._clock()
            prids = tuple(r.rid for r in group if r.profile)
            with _TRACE.span(
                "writer.apply", "serve",
                kind=group[0].kind, batch=len(group),
                base_epoch=self.instance.epoch,
                **({"profile_rids": prids} if prids else {}),
            ) as sp:
                results = self._apply_update_group(group)
                sp.set(epoch=self.instance.epoch)
            self._record(
                group, results, t0, self._clock(),
                self.instance.epoch, False,
            )
        return bool(self.queue or self._writer is not None)

    # -- deadlines -----------------------------------------------------------

    def _expire(self, group: list[_Request]) -> list[_Request]:
        """Split expired members out of one admission group (recorded as
        admission-stage :class:`DeadlineError`); returns the live rest."""
        now = self._clock()
        expired = [
            r for r in group if r.deadline is not None and now > r.deadline
        ]
        if not expired:
            return group
        results = {}
        for r in expired:
            self._m_deadline["admission"].inc()
            _TRACE.instant(
                "deadline.miss", "serve", rid=r.rid, stage="admission",
                kind=r.kind,
            )
            results[r.rid] = DeadlineError(
                r.rid,
                f"deadline expired {now - r.deadline:.6f}s before admission",
                stage="admission",
            )
        self._record(expired, results, now, now, -1, False)
        return [r for r in group if r.deadline is None or now <= r.deadline]

    def _deadline_checker(self, deadline: float | None, rid: int = -1):
        """A between-strata callback for ``MaterializedInstance.apply_txn``.

        Raises inflight-stage :class:`DeadlineError` once the clock passes
        ``deadline`` — the transaction aborts mid-propagation and publishes
        nothing (MVCC rollback), so a deadline-failed update leaves no
        trace beyond its WAL abort marker.
        """
        if deadline is None:
            return None

        def check() -> None:
            now = self._clock()
            if now > deadline:
                self._m_deadline["inflight"].inc()
                _TRACE.instant(
                    "deadline.miss", "serve", rid=rid, stage="inflight"
                )
                raise DeadlineError(
                    rid,
                    f"deadline crossed {now - deadline:.6f}s into propagation",
                    stage="inflight",
                )

        return check

    @staticmethod
    def _group_deadline(group: list[_Request]) -> float | None:
        """The coalesced group's effective in-flight deadline (the soonest
        member's; the fallback path re-checks each member's own)."""
        deadlines = [r.deadline for r in group if r.deadline is not None]
        return min(deadlines) if deadlines else None

    # -- retry (transient writer failures) -------------------------------------

    def _apply_with_retry(self, fn, rid: int, deadline: float | None):
        """Per-request fallback application with jittered retries.

        Transient failures (anything but a deadline miss) retry up to
        ``limits.max_retries`` times inside the ``writer_timeout`` budget,
        sleeping a seeded uniform jitter scaled by the attempt number —
        the classic collision-avoidance backoff, deterministic under a
        virtual clock.  Without limits this is exactly one attempt.
        """
        lim = self.limits
        attempts = 1 + (lim.max_retries if lim is not None else 0)
        t_start = self._clock()
        result = self._apply(fn, rid)
        for attempt in range(1, attempts):
            if not isinstance(result, RequestError):
                return result
            if isinstance(result, DeadlineError):
                return result          # retrying cannot un-miss a deadline
            if (
                lim.writer_timeout is not None
                and self._clock() - t_start >= lim.writer_timeout
            ):
                break
            if deadline is not None and self._clock() > deadline:
                break
            self._m_retries.inc()
            _TRACE.instant("writer.retry", "serve", rid=rid, attempt=attempt)
            if lim.retry_jitter:
                self._sleep(lim.retry_jitter * self._retry_rng.random() * attempt)
            result = self._apply(fn, rid)
        return result

    def _pop_query_run(self) -> list[_Request] | None:
        """The next query run the MVCC loop may serve right now.

        Normally the run at the queue head.  When the head is an update that
        cannot start yet (a writer is still in flight), queries deeper in
        the queue would otherwise wait out the *current* update too — so the
        first query run beyond the blocked head is served instead.  Under
        snapshot visibility that reordering is sound: the overtaken updates
        had not published, and the queries read a consistent earlier epoch.
        """
        if not self.queue:
            return None
        if self.queue[0].kind == "query":
            return self._admit()
        if self._writer is None or not self._writer[0].is_alive():
            return None        # the head update can start (after a cheap reap)
        idx = next(
            (i for i, r in enumerate(self.queue) if r.kind == "query"), None
        )
        if idx is None:
            return None
        group: list[_Request] = []
        while (
            len(group) < self.max_batch
            and idx < len(self.queue)
            and self.queue[idx].kind == "query"
        ):
            group.append(self.queue[idx])
            del self.queue[idx]
        return group

    # -- query batches (reader path) ------------------------------------------

    def _serve_queries(self, group: list[_Request]) -> None:
        group = self._expire(group)
        if not group:
            return
        t0 = self._clock()
        snap = self.instance.pin()
        # "concurrent" = an update is genuinely mid-flight AND this batch
        # pinned the writer's base epoch — a writer that already published
        # (even if its thread hasn't exited) no longer affects this read,
        # which must count as idle in the latency split
        writer = self._writer
        concurrent = (
            writer is not None and writer[0].is_alive() and snap.epoch == writer[4]
        )
        try:
            with _TRACE.span(
                "serve.queries", "serve",
                batch=len(group), epoch=snap.epoch, concurrent=concurrent,
            ):
                results = {}
                for r in group:
                    if r.payload.get("on_demand"):
                        fn = lambda r=r: self._demand_serve(r, snap)  # noqa: E731
                    else:
                        fn = lambda r=r: self.instance.query(  # noqa: E731
                            r.rel,
                            where=r.payload["where"],
                            snapshot=snap,
                            **r.payload["kw"],
                        )
                    if not (_TRACE.enabled or r.profile):
                        # the historical hot path, untouched: no span, no
                        # estimate, nothing allocated per request
                        results[r.rid] = self._apply(fn, r.rid)
                        continue
                    results[r.rid] = self._serve_one_query(r, fn, snap)
        finally:
            snap.release()
        self._record(group, results, t0, self._clock(), snap.epoch, concurrent)

    def _serve_one_query(self, r: _Request, fn, snap):
        """One traced/profiled query: a per-request ``query`` span carrying
        the result cardinality — and, when profiled, the selection estimate
        plus a ``query``-level misestimation observation."""
        attrs = {"rid": r.rid, "rel": r.rel}
        if r.profile:
            attrs["profile_rid"] = r.rid
        with _TRACE.span("query", "serve", **attrs) as qs:
            res = self._apply(fn, r.rid)
            if not isinstance(res, RequestError):
                qs.set(rows=len(res))
                if r.profile:
                    try:
                        bounds = self.instance.resolve_bounds(
                            r.payload["where"], **r.payload["kw"]
                        )
                        est = self.instance.query_estimate(
                            r.rel, bounds, snapshot=snap
                        )
                    except Exception:       # noqa: BLE001 — estimates are advisory
                        est = None
                    if est is not None:
                        qs.set(est_rows=est)
                        self._m_misest["query"].observe(
                            misestimation_ratio(len(res), est)
                        )
        return res

    # -- demand-specialized serving (on_demand queries) -----------------------

    def _demand_serve(self, r: _Request, snap) -> np.ndarray:
        """One ``on_demand=True`` query: demand LRU, or silent fallback.

        Every exit is a valid answer — fallbacks serve the ordinary
        selection over the full materialization and are *counted*, never
        surfaced as request errors.  Note the demand path reads the base
        instance's **latest published** epoch (the slice is built from it
        and invalidated when it changes), not the batch's pinned snapshot.
        """
        inst = self.instance
        bounds = inst.resolve_bounds(r.payload["where"], **r.payload["kw"])
        pattern = self._demand_pattern(r.rel, bounds)
        if pattern is None:
            # nothing to specialize on: no point bounds, or not IDB
            self._m_demand_fallbacks.inc()
            _TRACE.instant("demand.fallback", "serve", rid=r.rid, rel=r.rel)
            return inst.query(r.rel, where=bounds, snapshot=snap)
        seed = tuple(
            int(bounds[c]) for c, ch in enumerate(pattern) if ch == "b"
        )
        if any(v < 0 or v >= inst.domain for v in seed):
            # out-of-domain constants match nothing: answer empty without
            # specializing (seeding would grow the slice's domain for a
            # provably empty result)
            self._m_demand_hits.inc()
            return np.zeros((0, inst.plan.program.arity_of(r.rel)), np.int32)
        dinst = self._demand_instance(r.rel, pattern, seed)
        if dinst is None:
            # cached fallback decision (DL4xx): counted per query served
            self._m_demand_fallbacks.inc()
            _TRACE.instant(
                "demand.fallback", "serve",
                rid=r.rid, rel=r.rel, pattern=pattern,
            )
            return inst.query(r.rel, where=bounds, snapshot=snap)
        return dinst.demand_query(bounds)

    def _demand_pattern(self, rel: str, bounds: dict) -> str | None:
        """Binding pattern of one bound query, or None when the demand path
        cannot apply (non-IDB relation, no point bounds, bad columns —
        range bounds stay ordinary filters and never make a column 'b')."""
        inst = self.instance
        if rel not in inst.strat.idb or not bounds:
            return None
        arity = inst.plan.program.arity_of(rel)
        if not all(isinstance(c, int) and 0 <= c < arity for c in bounds):
            return None        # the fallback path raises the usual errors
        point = {c for c, v in bounds.items() if not isinstance(v, tuple)}
        if not point:
            return None
        return "".join("b" if c in point else "f" for c in range(arity))

    def _demand_instance(self, rel: str, pattern: str, seed: tuple):
        """The cached demand instance for ``(rel, pattern)`` — specializing
        on miss or epoch-staleness, ``None`` for a fallen-back transform."""
        key = (rel, pattern)
        with self._demand_lock:
            entry = self._demand_instances.get(key)
            if (
                entry is not None
                and entry["base_epoch"] != self.instance.epoch
            ):
                # the base published since this slice was built: stale
                del self._demand_instances[key]
                entry = None
            if entry is not None:
                self._demand_instances.move_to_end(key)
                if entry["instance"] is not None:
                    self._m_demand_hits.inc()
                return entry["instance"]
            self._m_demand_misses.inc()
            t0 = time.perf_counter()
            with _TRACE.span(
                "demand.specialize", "serve", rel=rel, pattern=pattern
            ) as sp:
                handles = self.instance.vstore.handles
                sizes = {
                    name: float(getattr(handles.get(name), "count", 0))
                    for name in self.instance.strat.edb
                }
                _plan, transform = self.instance.cache.get_demand(
                    self.instance.plan.program, rel, pattern,
                    sizes=sizes, domain=self.instance.domain,
                )
                dinst = (
                    MaterializedInstance.specialize(
                        self.instance, transform, seed
                    )
                    if transform.ok else None
                )
                sp.set(ok=transform.ok)
            self._m_demand_specialize.observe(time.perf_counter() - t0)
            self._demand_instances[key] = {
                "instance": dinst,
                "transform": transform,
                "base_epoch": self.instance.epoch,
            }
            while len(self._demand_instances) > self._demand_cap:
                self._demand_instances.popitem(last=False)
            return dinst

    # -- update batches (writer path) -----------------------------------------

    def _start_writer(self, group: list[_Request]) -> None:
        t0 = self._clock()
        out: dict = {}
        base_epoch = self.instance.epoch

        prids = tuple(r.rid for r in group if r.profile)

        def work() -> None:
            # epoch lineage: base_epoch is what this group builds on;
            # the published epoch lands on the span when the apply returns.
            # profile_rids marks this span as the subtree root for every
            # profiled member of the group (see repro_torch.obs.profile)
            with _TRACE.span(
                "writer.apply", "serve",
                kind=group[0].kind, batch=len(group), base_epoch=base_epoch,
                **({"profile_rids": prids} if prids else {}),
            ) as sp:
                try:
                    out["results"] = self._apply_update_group(group)
                finally:
                    out["t1"] = self._clock()
                    out["epoch"] = self.instance.epoch
                    sp.set(epoch=out["epoch"])

        th = threading.Thread(target=work, name="datalog-writer", daemon=True)
        self._writer = (th, group, out, t0, base_epoch)
        th.start()

    def _reap_writer(self) -> None:
        """Join the in-flight update batch (if any) and record its results."""
        if self._writer is None:
            return
        th, group, out, t0, _epoch0 = self._writer
        th.join()
        self._writer = None
        results = out.get("results") or {
            r.rid: RequestError(r.rid, "writer thread died before producing results")
            for r in group
        }
        self._record(
            group, results, t0, out.get("t1", self._clock()),
            out.get("epoch", -1), False,
        )

    def _apply_update_group(self, group: list[_Request]):
        self._m_groups.inc()
        self._m_coalesced.inc(len(group))
        if group[0].kind == "txn":
            results = self._apply_txn_group(group)
        else:
            results = self._apply_legacy_group(group)
        self._observe_updates(results)
        return results

    def _observe_updates(self, results: dict) -> None:
        """Row-level counters from the distinct batches in one result set.

        A coalesced group replicates ONE batch's stats per rid (per-rid
        copies of the same applied epoch), so batches are deduped by the
        epoch they published — counting per rid would multiply the row
        totals by the group size.  Per-request fallback applications each
        publish their own epoch and count once.
        """
        seen: set[int] = set()
        for res in results.values():
            if not isinstance(res, UpdateStats) or res.epoch in seen:
                continue
            seen.add(res.epoch)
            self._m_inserted.inc(res.inserted)
            self._m_removed.inc(res.removed)
            self._m_derived.inc(res.derived)
            self._m_retracted.inc(res.retracted)
            if res.full_rebuild:
                self._m_rebuilds.inc()
            ests = self._delta_estimates(res)
            for idx, actual in res.derived_by_stratum.items():
                est = ests.get(idx)
                if est is not None:
                    self._m_misest["stratum"].observe(
                        misestimation_ratio(actual, est)
                    )

    def _delta_estimates(self, res: UpdateStats) -> dict[int, float]:
        """Per-stratum delta estimates for one applied transaction.

        The plan estimate's :meth:`~repro_torch.obs.explain.PlanEstimate.
        scaled_delta` linearization, seeded with the rows each op actually
        changed — what the stratum's Δ total *should* have been if the
        System-R guesses were right.
        """
        plan_est = getattr(self.instance, "plan_estimate", None)
        if plan_est is None:
            return {}
        delta_rows: dict[str, float] = {}
        for op in res.ops:
            delta_rows[op.rel] = delta_rows.get(op.rel, 0.0) + op.applied
        if not delta_rows:
            return {}
        return plan_est.scaled_delta(delta_rows)

    def _apply_txn_group(self, group: list[_Request]):
        """One group-commit of coalesced transactions.

        The members' ops concatenate in submission order and apply as ONE
        instance transaction — one epoch, one Δ/∇ propagation pass over the
        stratification, one framed WAL group with one fsync (admission
        checked compatibility, so the merge is equivalent to sequential
        application).  Each rid gets its own ``UpdateStats`` copy carrying
        its own per-op slices.  A failed group falls back per-transaction
        behind the same rollback-boundary guard as the legacy path;
        acknowledged-failed transactions get txn-granularity abort markers
        so recovery never redoes them.
        """
        all_ops = [op for r in group for op in r.payload]
        epoch0 = self.instance.epoch
        token: str | None = None
        if self.durability is not None:
            # WAL-before-publish: the whole bracket (one fsync on the COMMIT
            # frame) is durable before any effect can become visible
            token = self.durability.log_txn(
                [(rel, op, rows) for op, rel, rows in all_ops], epoch0 + 1
            )
        # the coalesced pass runs under the SOONEST member's deadline: if any
        # member would miss, the whole group aborts (publishing nothing) and
        # the fallback below re-tries each member under its own deadline
        check = self._deadline_checker(
            self._group_deadline(group), rid=group[0].rid
        )
        try:
            # the kwarg rides only when a deadline exists: instances (and
            # test wrappers) predating ``deadline_check`` keep working, and
            # the deadline-free path stays bit-for-bit the historical call
            batch = (
                self.instance.apply_txn(all_ops) if check is None
                else self.instance.apply_txn(all_ops, deadline_check=check)
            )
            results: dict = {}
            i = 0
            for r in group:
                n = len(r.payload)
                results[r.rid] = replace(
                    batch,
                    requested=sum(len(rows) for _, _, rows in r.payload),
                    ops=[replace(o) for o in batch.ops[i : i + n]],
                    modes=dict(batch.modes),
                    iterations=dict(batch.iterations),
                )
                i += n
            return results
        except Exception as exc:
            if self.durability is not None:
                self.durability.abort_txn(token, epoch0 + 1)
            if self.instance.epoch != epoch0:
                return {
                    r.rid: RequestError(
                        r.rid,
                        "RollbackError: coalesced batch left partial state; "
                        "refusing per-request replay",
                    )
                    for r in group
                }
            if len(group) == 1 and isinstance(exc, DeadlineError):
                # single member: the coalesced pass ran under exactly this
                # request's deadline — its inflight miss IS the verdict
                exc.rid = group[0].rid
                return {group[0].rid: exc}
            results = {}
            for r in group:
                # a member that expired while the coalesced attempt burned
                # its deadline is failed HERE — before its fallback record
                # reaches the WAL, so recovery can never replay it
                now = self._clock()
                if r.deadline is not None and now > r.deadline:
                    self._m_deadline["admission"].inc()
                    _TRACE.instant(
                        "deadline.miss", "serve", rid=r.rid, stage="admission",
                        kind=r.kind,
                    )
                    results[r.rid] = DeadlineError(
                        r.rid,
                        f"deadline expired {now - r.deadline:.6f}s "
                        "before fallback application",
                        stage="admission",
                    )
                    continue
                predicted = self.instance.epoch + 1
                tok: str | None = None
                if self.durability is not None:
                    tok = self.durability.log_txn(
                        [(rel, op, rows) for op, rel, rows in r.payload],
                        predicted,
                    )
                results[r.rid] = self._apply_with_retry(
                    lambda r=r: (
                        self.instance.apply_txn(r.payload)
                        if r.deadline is None
                        else self.instance.apply_txn(
                            r.payload,
                            deadline_check=self._deadline_checker(
                                r.deadline, rid=r.rid
                            ),
                        )
                    ),
                    r.rid,
                    r.deadline,
                )
                if self.durability is not None and isinstance(
                    results[r.rid], RequestError
                ):
                    self.durability.abort_txn(tok, predicted)
            return results

    def _apply_legacy_group(self, group: list[_Request]):
        """One coalesced insert/delete batch, with isolated fallback.

        Each rid gets its OWN stats slice (``requested`` is the request's row
        count; batch-level fields are copies, not aliases — mutating one
        result must never bleed into its batch neighbors').  A failed
        coalesced attempt publishes no epoch (MVCC rollback), so per-request
        replay cannot double-apply; the epoch counter is checked anyway, and
        replay is refused if a failure somehow left published state behind.
        """
        fn = getattr(self.instance, self._UPDATE_FNS[group[0].kind])
        epoch0 = self.instance.epoch
        if self.durability is not None:
            # WAL-before-publish: every record of the group is durable (one
            # batched fsync) before any effect can become visible.  The
            # logged epoch is the one this batch publishes if it mutates;
            # replay is redo-idempotent, so a no-op or failed batch's record
            # is harmless.
            self.durability.log_group(
                [(r.rel, r.kind, r.payload) for r in group], epoch0 + 1
            )
        # the deprecation already surfaced at submit_* time; delegating
        # through the shim here (kept so tests can monkeypatch
        # insert_facts/retract_facts) must not re-warn from library
        # internals on every batch.  The flag is instance state read only
        # on this (single) writer thread — never the process-global warning
        # filters, which are not thread-safe to mutate.
        def quiet(call):
            self.instance._quiet_shims = True
            try:
                return call()
            finally:
                self.instance._quiet_shims = False

        try:
            rows = np.concatenate([r.payload for r in group])
            batch = quiet(lambda: fn(group[0].rel, rows))
            return {
                r.rid: replace(
                    batch,
                    requested=len(r.payload),
                    modes=dict(batch.modes),
                    iterations=dict(batch.iterations),
                )
                for r in group
            }
        except Exception:
            if self.durability is not None:
                # the coalesced attempt failed: abort every group record
                # (each fallback request re-logs below at its own predicted
                # epoch, so a checkpoint landing mid-fallback can't truncate
                # a record whose effects it doesn't contain).  Without the
                # abort markers, a batch that failed *transiently* here
                # could succeed when its records replay on recovery — and
                # the restored state would contain rows whose submitters
                # were told they failed.
                self.durability.abort_group(
                    [(r.rel, r.kind, r.payload) for r in group], epoch0 + 1
                )
            if self.instance.epoch != epoch0:
                # a failed attempt must publish nothing — if an epoch landed
                # anyway, re-applying would double-apply the committed rows
                return {
                    r.rid: RequestError(
                        r.rid,
                        "RollbackError: coalesced batch left partial state; "
                        "refusing per-request replay",
                    )
                    for r in group
                }
            results = {}
            for r in group:
                now = self._clock()
                if r.deadline is not None and now > r.deadline:
                    # expired during the coalesced attempt: fail before its
                    # fallback record reaches the WAL (same contract as txns)
                    self._m_deadline["admission"].inc()
                    _TRACE.instant(
                        "deadline.miss", "serve", rid=r.rid, stage="admission",
                        kind=r.kind,
                    )
                    results[r.rid] = DeadlineError(
                        r.rid,
                        f"deadline expired {now - r.deadline:.6f}s "
                        "before fallback application",
                        stage="admission",
                    )
                    continue
                predicted = self.instance.epoch + 1
                if self.durability is not None:
                    self.durability.log_group(
                        [(r.rel, r.kind, r.payload)], predicted
                    )
                results[r.rid] = self._apply_with_retry(
                    lambda r=r: quiet(lambda: fn(r.rel, r.payload)),
                    r.rid,
                    r.deadline,
                )
                if self.durability is not None and isinstance(
                    results[r.rid], RequestError
                ):
                    # acknowledged as failed: its re-logged record must not
                    # be redone on recovery
                    self.durability.abort_group(
                        [(r.rel, r.kind, r.payload)], predicted
                    )
            return results

    # -- shared bookkeeping ---------------------------------------------------

    def _record(
        self,
        group: list[_Request],
        results: dict,
        t0: float,
        t1: float,
        epoch: int,
        concurrent: bool,
    ) -> None:
        per_req = (t1 - t0) / len(group)
        is_update = group[0].kind in self._UPDATE_KINDS
        service_hist = self._m_update_seconds if is_update else self._m_query_seconds
        for r in group:
            self.done[r.rid] = results[r.rid]
            self.stats.add(
                RequestRecord(
                    r.rid, r.kind, r.rel, len(group),
                    t0 - r.submitted, per_req, epoch, concurrent,
                )
            )
            counter = self._m_requests.get(r.kind)
            if counter is None:     # future kinds get a labeled counter lazily
                counter = self._m_requests[r.kind] = self.metrics_registry.counter(
                    "datalog_requests_total", labels={"kind": r.kind}
                )
            counter.inc()
            if isinstance(results[r.rid], RequestError):
                self._m_errors.inc()
            self._m_queue_wait.observe(t0 - r.submitted)
            service_hist.observe(per_req)
            if r.profile:
                self._finish_profile(r, results[r.rid], t0, per_req, epoch)
        while len(self.done) > self.history:     # evict oldest results
            self.done.pop(next(iter(self.done)))
        while len(self._profiles) > self.history:
            self._profiles.pop(next(iter(self._profiles)))
        if self.durability is not None and is_update:
            self._ckpt_wake.set()       # nudge the checkpointer's policy check

    def _finish_profile(
        self, r: _Request, result, t0: float, service: float, epoch: int
    ) -> None:
        """Assemble the finished request's :class:`FixpointProfile` from the
        tracer snapshot, store it for :meth:`profile`, and capture it into
        the slow-query ring when the sojourn crossed the limit."""
        derived = None
        est_by_stratum: dict[int, float] = {}
        if isinstance(result, UpdateStats):
            derived = result.derived
            est_by_stratum = self._delta_estimates(result)
        queued = t0 - r.submitted
        prof = build_profile(
            _TRACE.spans(),
            r.rid,
            kind=r.kind,
            relation=r.rel,
            queued=queued,
            service=service,
            epoch=epoch,
            est_by_stratum=est_by_stratum,
            derived=derived,
            device_memory=device_memory_stats(self.instance.device),
        )
        self._profiles[r.rid] = prof
        self._m_profiles.inc()
        self._profile_off()
        lim = self.limits
        if (
            lim is not None
            and lim.slow_query_threshold is not None
            and prof.sojourn_seconds > lim.slow_query_threshold
        ):
            prof.slow = True
            self._slow.append(prof)
            self._m_slow_queries.inc()
            _TRACE.instant(
                "slow_query", "serve",
                rid=r.rid, kind=r.kind, sojourn=prof.sojourn_seconds,
            )

    @staticmethod
    def _apply(fn, rid: int):
        try:
            return fn()
        except RequestError as e:
            # typed serving failures (DeadlineError from an in-flight check,
            # admission diagnostics) keep their type — and their stage/
            # diagnostics payload — instead of flattening to RequestError
            e.rid = rid
            return e
        except Exception as e:                     # noqa: BLE001 — serving loop
            return RequestError(rid, f"{type(e).__name__}: {e}")

    def _admit(self) -> list[_Request]:
        """Admission batch: the longest coalescible run at the queue head.

        Queries batch with queries (they share one pinned snapshot); legacy
        inserts/deletes batch with same-kind same-relation neighbors (one
        update call); transactions batch with
        *compatible* transactions — the merged op list must still be a
        valid transaction, i.e. no row inserted by one member and retracted
        by another — and the whole group commits as one epoch.
        """
        with _TRACE.span(
            "admission", "serve", queue_depth=len(self.queue)
        ) as sp:
            group = self._admit_impl()
            sp.set(kind=group[0].kind, batch=len(group))
            return group

    def _admit_impl(self) -> list[_Request]:
        head = self.queue.popleft()
        group = [head]
        if head.kind == "txn":
            merged = None       # row sets only materialize if a neighbor exists
            while (
                self.queue
                and len(group) < self.max_batch
                and self.queue[0].kind == "txn"
            ):
                if merged is None:
                    merged = _TxnRowSets(head.payload)
                if not merged.try_add(self.queue[0].payload):
                    break
                group.append(self.queue.popleft())
            return group
        while self.queue and len(group) < self.max_batch:
            nxt = self.queue[0]
            if nxt.kind != head.kind:
                break
            if head.kind in self._UPDATE_FNS and nxt.rel != head.rel:
                break
            group.append(self.queue.popleft())
        return group

    def mvcc_stats(self) -> dict:
        """Epoch/pin/reclamation counters plus how many query *requests*
        were served while an update was in flight (per-request, matching
        ``ServerStats.latency(concurrent=True)['count']``).

        .. deprecated::
            Prefer :meth:`metrics` — the unified registry carries the same
            epoch/pin gauges (``datalog_epoch``, ``datalog_reader_pins``,
            ``datalog_live_epochs``) plus everything else in one snapshot.
            Kept (no warning) for dashboards scraping the historical shape.
        """
        s = self.instance.vstore.stats()
        # copy-under-lock: iterating the live deque from a reader thread
        # while the serving loop appends raises RuntimeError mid-iteration
        s["concurrent_reads"] = sum(
            1 for r in self.stats.snapshot() if r.kind == "query" and r.concurrent
        )
        return s


    # -- durability (WAL + background checkpointer) ---------------------------

    def _checkpoint_loop(self) -> None:
        """Snapshot off a reader pin whenever the checkpoint policy fires.

        Runs on its own daemon thread for the server's lifetime, woken after
        each published update batch (and on a poll heartbeat).  Everything it
        does is read-side — pin an epoch, wait on its CUDA event, copy its
        immutable handles to the host, truncate the WAL — so it overlaps the
        writer thread and in-flight query batches; it never takes the
        instance write lock.
        """
        poll = self.durability.config.poll_seconds
        while not self._ckpt_stop.is_set():
            self._ckpt_wake.wait(timeout=poll)
            self._ckpt_wake.clear()
            if self._ckpt_stop.is_set():
                break
            try:
                if self.durability.should_checkpoint(self.instance.epoch):
                    self.durability.checkpoint(self.instance)
            except Exception as e:      # noqa: BLE001 — keep serving on failure
                with self._ckpt_err_lock:
                    self.checkpoint_errors.append(f"{type(e).__name__}: {e}")
                    del self.checkpoint_errors[:-64]

    def checkpoint_now(self) -> str | None:
        """Force a checkpoint of the latest published epoch (blocking)."""
        if self.durability is None:
            raise RuntimeError("server was constructed without durability=")
        return self.durability.checkpoint(self.instance)

    def durability_stats(self) -> dict:
        """WAL/checkpoint counters (empty dict when durability is off).

        .. deprecated::
            Prefer :meth:`metrics` — the unified registry carries the WAL
            and checkpoint surfaces (``datalog_wal_*``,
            ``datalog_checkpoint*``) including fsync/checkpoint duration
            histograms this dict never had.  Kept (no warning) for callers
            scraping the historical shape.
        """
        if self.durability is None:
            return {}
        s = self.durability.stats()
        with self._ckpt_err_lock:
            s["checkpoint_errors"] = len(self.checkpoint_errors)
        return s

    def close(self) -> None:
        """Stop the checkpointer thread and fsync-close the WAL.

        Idempotent; does NOT take a final checkpoint — the WAL already holds
        every published batch, which is the durability contract.
        """
        self._ckpt_stop.set()
        self._ckpt_wake.set()
        if self._ckpt_thread is not None:
            self._ckpt_thread.join(timeout=5.0)
            self._ckpt_thread = None
        if self.durability is not None:
            self.durability.close()
