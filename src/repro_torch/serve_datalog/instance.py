"""MaterializedInstance: a fixpointed Datalog program that accepts deltas.

State lives in a :class:`~repro_torch.core.versioned_store.VersionedStore` —
an append-only chain of published epochs, each a complete immutable handle
map.  Reads (:meth:`MaterializedInstance.query`, :meth:`MaterializedInstance.
relation`) pin the latest published epoch and see a consistent snapshot no
matter what a concurrent writer does.  The write surface is
:meth:`MaterializedInstance.apply_txn`: one *transaction* — an ordered list
of ``(op, rel, rows)`` operations mixing inserts and retractions across any
number of EDB relations — commits as exactly one epoch, built in a
*private* handle map and published with one atomic pointer swap.  A failed
transaction publishes nothing — rollback is "the epoch never existed" — and
superseded epochs are reclaimed once their last reader pin drops (see
``versioned_store.py``).  The per-relation calls
(:meth:`MaterializedInstance.insert_facts`,
:meth:`MaterializedInstance.retract_facts`) survive as deprecated one-op
wrappers over ``apply_txn``.

A transaction's storage-level effects are applied op by op, then *all* its
Δ (inserted) and ∇ (removed) views are seeded at once and propagated in ONE
pass over the stratification.  Per affected stratum one of the update modes
applies (recorded in :class:`UpdateStats.modes`):

* ``bitmatrix`` — the stratum matched PBME at materialization time; the
  packed closure and arc matrices stay on the device and the update runs the
  incremental frontier (``tc_increment`` / ``sg_increment``) through the
  ``bitmm`` kernel at row-compacted shapes (M = k frontier rows).
* ``delta`` — ingest variants (one per occurrence of a changed relation)
  evaluate with the changed atom read from the external Δ, the results are
  set-differenced against the stored IDB to seed ΔR, and the engine's
  resumable ``_seminaive_loop`` runs from iteration 1.
* ``dred`` — a retraction reaching a tuple-backed, aggregate-free stratum:
  the engine's over-delete/re-derive pass (``Engine.dred_stratum``).
* ``full`` — monotonicity is lost (negation over a changed relation, a
  non-dense aggregate, an upstream recompute that retracted facts) or a
  retraction reaches a dense or PBME-resident stratum: the stratum is
  recomputed from scratch and its old-vs-new diff, taken on the device,
  flows downstream.

Updates that introduce constants outside the materialized active domain
rebuild the whole instance (dense arrays and bit matrices are sized by the
domain) — still one epoch.

**Device.**  The instance runs on its engine's device: CUDA unless it is
given ``device="cpu"``, and it raises where CUDA is absent.  On CUDA every
write (the materialization, each transaction) runs on the instance's own
stream, so reads on other streams never queue behind a writer's kernels;
each published epoch carries an event recorded on that stream after its
last kernel, and every read here waits on it on the card before it touches
the epoch's tensors (readers of ``pin().handles`` call
``Snapshot.wait_ready()``).  Tensors an epoch owns stay referenced by the
store until the epoch is reclaimed, and a read copies its result to the
host before its pin drops, so no freed block is still in use by a kernel
of another stream.

**Durability.**  :meth:`MaterializedInstance.restore` warm-starts from a
durability root (``repro_torch.persist``, the reference's on-disk format):
the newest valid snapshot is copied onto the device on the writer's stream,
packed PBME matrices included, and the WAL tail replays through
:meth:`apply_txn`.

**Admission and demand.**  Programs are admitted through the static
analyzer (``analysis=ADMISSION_CONFIG``, see ``plan_cache.py``).
:meth:`MaterializedInstance.specialize` builds a demand-specialized instance
from a magic-set transform (``repro_torch.analysis.demand``) on the base
instance's device; later bindings enter it through :meth:`seed_demand`, and
:meth:`demand_query` answers one bound query from the demanded slice.

Concurrency contract: any number of reader threads, one writer at a time
(enforced by an internal lock; ``DatalogServer`` runs a single writer
thread).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis import AnalysisConfig
from repro_torch.analysis.demand import DemandTransform
from repro_torch.core.analyzer import Stratum
from repro_torch.core.ast import Program
from repro_torch.core.bitmatrix import (
    bitmatrix_to_rows,
    edges_to_bitmatrix,
    eligible_plan,
    popcount,
    sg_increment,
    tc_increment,
)
from repro_torch.core.engine import Engine, EngineConfig, TupleView
from repro_torch.core.relation import (
    DenseAggRelation,
    DenseSetRelation,
    TupleRelation,
    _dedup_sorted,
    _key_column,
    _sort_pad,
    next_bucket,
)
from repro_torch.core.seminaive import ingest_variants
from repro_torch.core.setdiff import DSDState, set_difference
from repro_torch.core.versioned_store import Snapshot, VersionedStore
from repro_torch.obs.explain import PlanEstimate, estimate_plan, estimate_query_rows
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.relational.sort import SENTINEL
from repro_torch.serve_datalog.plan_cache import (
    ADMISSION_CONFIG,
    CompiledPlan,
    PlanCache,
    default_cache,
)

#: errors a WAL replay never skips: CUDA out of memory and the kernels'
#: launch and runtime errors are ``RuntimeError``s (see ``_replay_wal``)
_DEVICE_FAULTS = (RuntimeError, MemoryError)


@dataclass(frozen=True)
class TxnOp:
    """One operation of a write transaction (sugar over ``(op, rel, rows)``).

    ``op`` is ``"insert"`` or ``"delete"`` (``"retract"`` is accepted as an
    alias for ``"delete"`` everywhere transactions are submitted).
    """

    op: str
    rel: str
    rows: np.ndarray


@dataclass
class OpStats:
    """Per-operation slice of one transaction's :class:`UpdateStats`.

    ``applied`` counts the EDB tuples the op actually changed — genuinely
    new rows for inserts, rows that were present and are now gone for
    deletes (duplicate inserts / absent deletes contribute nothing).
    """

    op: str                              # "insert" | "delete"
    rel: str
    requested: int                       # rows in this op's payload
    applied: int = 0


@dataclass
class UpdateStats:
    """What one ``apply_txn`` transaction did, per op and per stratum.

    ``epoch`` is the epoch the transaction published (the pre-update epoch
    for no-op transactions, which publish nothing).  ``ops`` holds one
    :class:`OpStats` slice per operation; ``modes`` maps stratum index to the
    update mode that handled it (``bitmatrix`` / ``delta`` / ``dred`` /
    ``full``); ``iterations`` to the semi-naïve iteration count.
    ``read_set``/``write_set`` are the relations the transaction's
    propagation read / changed.
    """

    relation: str                        # op rel (single-op) or "a+b" summary
    requested: int                       # rows across all ops
    kind: str = "insert"                 # "insert" | "delete" | "txn"
    inserted: int = 0                    # genuinely-new EDB tuples
    removed: int = 0                     # EDB tuples actually deleted
    derived: int = 0                     # new IDB tuples across all strata
    retracted: int = 0                   # IDB tuples retracted across all strata
    seconds: float = 0.0
    full_rebuild: bool = False
    epoch: int = -1                      # epoch published by this txn
    modes: dict[int, str] = field(default_factory=dict)      # stratum → mode
    iterations: dict[int, int] = field(default_factory=dict)  # stratum → iters
    derived_by_stratum: dict[int, int] = field(default_factory=dict)
    ops: list[OpStats] = field(default_factory=list)          # per-op slices
    read_set: tuple[str, ...] = ()
    write_set: tuple[str, ...] = ()


@dataclass
class _WriteTxn:
    """Private state of one in-flight MVCC write (the next epoch, unbuilt).

    ``store`` starts as a shallow copy of the base epoch's handle map and is
    mutated freely — handles are immutable, so the base epoch is untouched.
    ``bm``/``domain`` mirror the bitmatrix residency state and active-domain
    size the same way.  ``mutated`` gates publication.
    """

    base: Snapshot                  # pinned epoch the txn builds on
    store: dict                     # private next-epoch handle map
    bm: dict                        # private PBME residency state
    domain: int                     # next-epoch active-domain size
    mutated: bool = False


class MaterializedInstance:
    """A program's stratification + fixpointed relations, open for updates.

    Construction parses/stratifies via the :class:`PlanCache`, evaluates the
    program to a fixpoint on ``device`` (CUDA by default), and installs the
    result as epoch 0 of the versioned store.
    """

    def __init__(
        self,
        program: Program | str,
        edb: dict[str, np.ndarray],
        config: EngineConfig | None = None,
        cache: PlanCache | None = None,
        analysis: "AnalysisConfig | None" = ADMISSION_CONFIG,
        device=None,
    ):
        self.cache = cache or default_cache()
        self.plan: CompiledPlan = self.cache.get(program, analysis=analysis)
        self.engine = Engine(config, device=device)
        self.device = self.engine.device
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        with self._on_writer_stream():
            self.engine.run(self.plan.program, edb, strat=self.plan.strat,
                            return_numpy=False)
            self.strat = self.plan.strat
            # the engine hands the handle map over: epochs own all handles, so
            # reclamation of superseded epochs actually frees device buffers
            handles = self.engine.take_store()
            domain = self.engine.domain
            self._install_state(
                handles, domain, 0, self._init_bitmatrix_state(handles, domain)
            )

    def _install_state(
        self, handles: dict, domain: int, epoch: int, bm: dict[int, dict]
    ) -> None:
        """Install the base epoch.  PBME residency rides along as the epoch's
        meta sidecar: a pinned snapshot observes (handles, bm) atomically."""
        self._bm: dict[int, dict] = bm
        self.cache.warm(self.plan, domain, buckets=self._hot_buckets(handles),
                        device=self.device)
        self.vstore = VersionedStore(
            handles, domain, epoch=epoch, meta=bm, ready=self._ready_event()
        )
        self.update_log: list[UpdateStats] = []
        self._write_lock = threading.Lock()
        # plan-time cost/cardinality estimates (EXPLAIN): computed once per
        # installed state and attached to the engine so stratum spans carry
        # est_rows next to actuals
        self.plan_estimate = self._make_plan_estimate(handles, domain, bm)
        self.engine.estimates = self.plan_estimate

    # -- the writer's stream ---------------------------------------------------

    def _on_writer_stream(self):
        """Context that runs the writer's work on the instance's stream."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _ready_event(self):
        """An event recorded on the writer's stream after everything queued
        so far (``None`` on the CPU)."""
        if self._stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self._stream)
        return event

    def _wait(self, snap: Snapshot) -> None:
        """Order the caller's current stream after ``snap``'s writer."""
        if snap.ready is not None:
            with torch.cuda.device(self.device):
                snap.wait_ready()

    # -- EXPLAIN ---------------------------------------------------------------

    def _make_plan_estimate(
        self, handles: dict, domain: int, bm: dict[int, dict]
    ) -> PlanEstimate:
        """EXPLAIN against concrete state: EDB actual sizes seed the
        System-R heuristics, stored IDB counts ride along as ``actuals``,
        and the predicted per-stratum mode comes from PBME residency plus
        the engine's materialization-time backend choice."""
        sizes = {
            name: float(getattr(handles.get(name), "count", 0))
            for name in self.strat.edb
        }
        actuals = {
            name: int(getattr(handles.get(name), "count", 0))
            for name in self.strat.idb
            if name in handles
        }
        modes: dict[int, str] = {}
        for stratum in self.strat.strata:
            if stratum.index in bm:
                modes[stratum.index] = "bitmatrix"
            else:
                modes[stratum.index] = self.engine.stats.backend_used.get(
                    stratum.preds[0], "tuple"
                )
        return estimate_plan(
            self.plan, sizes=sizes, domain=domain, modes=modes, actuals=actuals
        )

    def explain(self) -> PlanEstimate:
        """Fresh :class:`PlanEstimate` against the latest published epoch."""
        return self._make_plan_estimate(
            self.vstore.handles, self.vstore.domain, self._bm
        )

    def query_estimate(
        self, rel: str, bounds: dict, snapshot: Snapshot | None = None
    ) -> float:
        """Plan-time cardinality estimate for one selection."""
        handles = snapshot.handles if snapshot is not None else self.vstore.handles
        h = handles.get(rel)
        return estimate_query_rows(
            float(getattr(h, "count", 0)), self.vstore.domain, bounds
        )

    # -- the published view --------------------------------------------------

    @property
    def store(self):
        """The latest *published* epoch's handle map (read-only view; on CUDA
        wait on the epoch's event before reading its tensors)."""
        return self.vstore.handles

    @property
    def domain(self) -> int:
        """Active-domain size of the latest published epoch."""
        return self.vstore.domain

    @property
    def epoch(self) -> int:
        """Index of the latest published epoch (0 = the initial fixpoint)."""
        return self.vstore.epoch

    def pin(self) -> Snapshot:
        """Pin the latest published epoch for consistent reads.

        Pass the snapshot to :meth:`query`/:meth:`relation` (or read
        ``snapshot.handles`` after ``snapshot.wait_ready()``); release it (or
        use ``with``) when done so the epoch's buffers can be reclaimed.
        """
        return self.vstore.pin()

    # -- crash-safe warm-start -----------------------------------------------

    @classmethod
    def restore(
        cls,
        path: str,
        program: "Program | str | None" = None,
        config: EngineConfig | None = None,
        cache: PlanCache | None = None,
        replay: bool = True,
        analysis: "AnalysisConfig | None" = ADMISSION_CONFIG,
        device=None,
    ) -> "MaterializedInstance":
        """Warm-start from a durability root: snapshot load + WAL replay.

        Loads the newest *valid* snapshot under ``path`` (torn tmp
        directories and checksum-failed snapshots are skipped — recovery
        always lands on a consistent epoch) onto ``device`` (CUDA unless
        given ``"cpu"``), installs its relation handles and packed PBME
        matrices as the store's base epoch — no re-fixpoint — and replays
        the WAL tail (records above the snapshot epoch) through
        :meth:`apply_txn`.  The result is bit-for-bit the pre-crash
        fixpoint, at a cost proportional to the WAL tail.  The root may
        have been written by either package.

        ``program`` may be omitted: the manifest embeds the program source
        (``repr(Program)`` parses back).  When given, its fingerprint must
        match the snapshot's.  ``restore_stats`` on the returned instance
        records what recovery did.
        """
        from repro_torch.persist.codec import (
            SnapshotError,
            latest_valid_snapshot,
            strat_hash,
        )
        from repro_torch.persist.manager import WAL_NAME
        from repro_torch.persist.wal import DeltaWAL

        self = cls.__new__(cls)
        self.engine = Engine(config, device=device)
        self.device = self.engine.device
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        with self._on_writer_stream():
            # the blocks are copied onto the card on the writer's stream; the
            # base epoch's ready event is recorded after them
            snap = latest_valid_snapshot(path, device=self.device)
            if snap is None:
                raise SnapshotError(f"no valid snapshot under {path!r}")
            source = program if program is not None else snap.program_source
            if not source:
                raise SnapshotError(
                    f"{snap.path}: manifest has no program source; pass program="
                )
            self.cache = cache or default_cache()
            self.plan = self.cache.get(source, analysis=analysis)
            if snap.fingerprint and self.plan.fingerprint != snap.fingerprint:
                raise SnapshotError(
                    f"{snap.path}: snapshot fingerprint {snap.fingerprint} does "
                    f"not match program fingerprint {self.plan.fingerprint}"
                )
            self.strat = self.plan.strat
            if snap.strat_hash and strat_hash(self.strat) != snap.strat_hash:
                # stratum indices key the PBME residency sidecar — replaying
                # into a differently-stratified plan would attach matrices to
                # the wrong strata
                raise SnapshotError(
                    f"{snap.path}: snapshot stratification {snap.strat_hash} "
                    "does not match this program's stratification"
                )
            self.engine.domain = snap.domain
            self.engine.strat = self.strat
            handles = dict(snap.handles)
            self._install_state(
                handles, snap.domain, snap.epoch,
                self._restore_bitmatrix_state(snap, handles, snap.domain),
            )
        self.restore_stats = {
            "snapshot_path": snap.path,
            "snapshot_epoch": snap.epoch,
            "replayed_records": 0,
            "replayed_batches": 0,
            "skipped_records": 0,
        }
        if replay:
            wal_path = os.path.join(path, WAL_NAME)
            if os.path.exists(wal_path):
                wal = DeltaWAL(wal_path, fsync="off")
                try:
                    self._replay_wal(wal, snap.epoch)
                finally:
                    wal.close()
        return self

    def _restore_bitmatrix_state(
        self, snap, handles: dict, domain: int
    ) -> dict[int, dict]:
        """PBME residency from the snapshot's packed matrices (already
        ``int32`` words on the device).

        A stratum that is PBME-eligible but missing from the snapshot (e.g.
        an engine-side checkpoint, which has no residency sidecar) is
        re-packed from the loaded relations — same result, just not free.
        """
        bm: dict[int, dict] = {}
        for stratum in self.strat.strata:
            plan = self._bm_eligible(stratum, domain)
            if plan is None or plan.edb not in handles:
                continue
            mats = snap.bitmatrix.get(stratum.index)
            if mats is not None and {"arc", "m"} <= set(mats):
                arc, m = mats["arc"], mats["m"]
            else:
                arc = self._packed(handles[plan.edb], domain)
                m = self._packed(handles[plan.idb], domain)
            bm[stratum.index] = {"plan": plan, "arc": arc, "m": m}
        return bm

    def _replay_wal(self, wal, after_epoch: int) -> None:
        """Redo the WAL tail through the incremental update drivers.

        Txn-framed groups (begin/op*/commit) re-apply as ONE
        :meth:`apply_txn` batch each — whole transactions or nothing, the
        pre-crash commit granularity; a framed transaction that raises on
        replay is skipped entirely (replaying it op-by-op would break the
        atomicity its submitter was promised).  Legacy bare records:
        consecutive records sharing (epoch, op, relation) were one coalesced
        server batch and re-apply as one single-op transaction, with the
        historical per-record fallback on failure (a record whose batch
        failed pre-crash never published, so skipping it on replay
        converges to the same state).

        Unlike the reference, a device failure is never skipped: CUDA out of
        memory and a kernel's launch or runtime error (``RuntimeError``s) say
        nothing about the transaction, and skipping one would drop a
        committed transaction in silence.  They propagate out of
        :meth:`restore`, which can be retried.
        """
        stats = self.restore_stats
        pending: list = []

        def flush() -> None:
            if not pending:
                return
            op, rel = pending[0].op, pending[0].rel
            rows = np.concatenate([r.rows for r in pending])
            try:
                self.apply_txn([(op, rel, rows)])
                stats["replayed_records"] += len(pending)
            except _DEVICE_FAULTS:
                raise
            except Exception:
                for rec in pending:
                    try:
                        self.apply_txn([(rec.op, rec.rel, rec.rows)])
                        stats["replayed_records"] += 1
                    except _DEVICE_FAULTS:
                        raise
                    except Exception:
                        stats["skipped_records"] += 1
            stats["replayed_batches"] += 1
            pending.clear()

        for txn in wal.replay_txns(after_epoch=after_epoch):
            if txn.token is None:       # legacy bare record: coalesce runs
                rec = txn.ops[0]
                if pending and (
                    rec.epoch != pending[0].epoch
                    or rec.op != pending[0].op
                    or rec.rel != pending[0].rel
                ):
                    flush()
                pending.append(rec)
                continue
            flush()
            try:
                self.apply_txn([(r.op, r.rel, r.rows) for r in txn.ops])
                stats["replayed_records"] += len(txn.ops)
            except _DEVICE_FAULTS:
                raise
            except Exception:
                stats["skipped_records"] += len(txn.ops)
            stats["replayed_batches"] += 1
        flush()

    def _hot_buckets(self, handles: dict) -> tuple[int, ...]:
        """Warm the *actual* materialized capacities, not just defaults."""
        caps = {self.engine.config.capacity_min, 2 * self.engine.config.capacity_min}
        for h in handles.values():
            if isinstance(h, TupleRelation):
                caps.add(h.capacity)
        return tuple(sorted(caps))

    # -- bitmatrix residency -------------------------------------------------

    def _bm_eligible(self, stratum: Stratum, domain: int):
        return eligible_plan(stratum, domain, self.engine.config)

    def _packed(self, handle: TupleRelation, domain: int) -> torch.Tensor:
        """A binary relation's packed n × n matrix, built on the device."""
        return edges_to_bitmatrix(handle.rows[: handle.count], domain)

    def _init_bitmatrix_state(self, handles: dict, domain: int) -> dict[int, dict]:
        """Keep PBME strata resident as packed matrices between updates."""
        bm: dict[int, dict] = {}
        for stratum in self.strat.strata:
            plan = self._bm_eligible(stratum, domain)
            if plan is None or plan.edb not in handles:
                continue
            arc = self._packed(handles[plan.edb], domain)
            m = self._packed(handles[plan.idb], domain)
            bm[stratum.index] = {"plan": plan, "arc": arc, "m": m}
        return bm

    # -- reads ---------------------------------------------------------------

    _ALIASES = {"src": 0, "x": 0, "key": 0, "dst": 1, "y": 1, "val": 1, "z": 2}

    def relation(self, rel: str, snapshot: Snapshot | None = None) -> np.ndarray:
        """Full contents of one relation (EDB or IDB) as numpy rows.

        Reads the latest published epoch, or the given pinned ``snapshot``.
        """
        snap = snapshot if snapshot is not None else self.vstore.latest()
        self._wait(snap)
        return self._rows_of(snap.handles, rel)

    def _rows_of(self, handles, rel: str) -> np.ndarray:
        h = handles.get(rel)
        if h is None:
            return np.zeros((0, self.plan.program.arity_of(rel)), np.int32)
        return h.to_numpy()

    def query(
        self,
        rel: str,
        *,
        where: dict | None = None,
        snapshot: Snapshot | None = None,
        **kw,
    ) -> np.ndarray:
        """Point/range selection, e.g. ``query("tc", src=3)`` or
        ``query("sssp", val=(0, 10))``; column indices also work via
        ``where={0: 3, 1: (lo, hi)}``.

        Without ``snapshot``, the read pins the latest published epoch for
        its duration; with a pinned :class:`Snapshot` from :meth:`pin`,
        repeated queries all observe that same epoch.
        """
        bounds = self.resolve_bounds(where, **kw)
        if snapshot is not None:
            return self._query_in(snapshot, rel, bounds)
        with self.vstore.pin() as snap:
            return self._query_in(snap, rel, bounds)

    def resolve_bounds(
        self, where: dict | None = None, **kw
    ) -> dict[int, int | tuple[int, int]]:
        """Column-index bounds from ``where=`` plus keyword aliases."""
        bounds: dict[int, int | tuple[int, int]] = dict(where or {})
        for name, v in kw.items():
            if name not in self._ALIASES:
                raise KeyError(
                    f"unknown query column {name!r}; use {sorted(self._ALIASES)}"
                    " or where={col_index: bound}"
                )
            bounds[self._ALIASES[name]] = v
        return bounds

    def _query_in(self, snap: Snapshot, rel: str, bounds: dict) -> np.ndarray:
        self._wait(snap)
        rows = self._tuple_rows(snap.handles, rel)
        if rows is None:
            return np.zeros((0, self.plan.program.arity_of(rel)), np.int32)
        if set(bounds) == {0}:
            # tables are sorted by column 0 (pads last): binary search + slice
            lo, hi = (
                bounds[0] if isinstance(bounds[0], tuple) else (bounds[0], bounds[0])
            )
            col = rows[:, 0].contiguous()
            keys = torch.tensor([lo, hi], dtype=torch.int32, device=col.device)
            l = int(torch.searchsorted(col, keys[:1], side="left"))
            h = int(torch.searchsorted(col, keys[1:], side="right"))
            with _TRACE.span("device.sync", "serve", what="query_rows"):
                return rows[l:h].cpu().numpy()
        out, count = self.cache.select(rows, bounds)
        with _TRACE.span("device.sync", "serve", what="query_rows"):
            return out[:count].cpu().numpy()

    def _tuple_rows(self, handles, rel: str):
        h = handles.get(rel)
        if h is None:
            return None
        if isinstance(h, TupleRelation):
            return h.rows
        cap = next_bucket(max(h.count, 1), self.engine.config.capacity_min)
        if isinstance(h, DenseSetRelation):
            return _key_column(h.member, cap)[:, None]
        if isinstance(h, DenseAggRelation):
            rows, _count = h.full_tuples(cap)
            return rows
        raise TypeError(type(h))

    # -- demand specialization -----------------------------------------------

    #: set on demand-specialized instances (see :meth:`specialize`); ``None``
    #: on ordinary full-materialization instances
    demand: "DemandTransform | None" = None

    @classmethod
    def specialize(
        cls,
        base: "MaterializedInstance",
        transform: DemandTransform,
        seed: tuple,
    ) -> "MaterializedInstance":
        """Build a demand-specialized instance from ``base``'s current EDB.

        ``transform`` is a successful :class:`~repro_torch.analysis.demand.
        DemandTransform`; ``seed`` is the first demanded binding (the bound
        columns' constants, in pattern order).  The specialized instance
        materializes only the demanded slice, on ``base``'s device with a
        writer stream of its own: the magic-transformed program runs over a
        copy of the base EDB plus a seed relation holding ``seed``.  Later
        bindings enter through :meth:`seed_demand` — plain EDB inserts, so
        the resumable semi-naïve Δ machinery (ingest variants) extends the
        slice incrementally; the base instance's MVCC and WAL state are
        never touched.
        """
        edb = {name: base.relation(name) for name in base.strat.edb}
        first = tuple(int(v) for v in seed)
        edb[transform.seed_rel] = np.asarray([first], np.int32).reshape(
            1, len(transform.bound_cols)
        )
        inst = cls(
            transform.program,
            edb,
            config=base.engine.config,
            cache=base.cache,
            analysis=None,
            device=base.device,
        )
        inst.demand = transform
        inst._demand_seeded = {first}
        return inst

    def seed_demand(self, values) -> bool:
        """Demand one more binding: insert it into the seed relation.

        Returns True when the seed was new (the magic fixpoint extended
        incrementally via the ordinary Δ path), False when it was already
        demanded (no work).  Idempotent under races: a duplicate insert is
        a no-op transaction that publishes nothing.
        """
        t = self.demand
        if t is None:
            raise RuntimeError("not a demand-specialized instance")
        seed = tuple(int(v) for v in values)
        if seed in self._demand_seeded:
            return False
        self.apply_txn(
            [("insert", t.seed_rel, np.asarray([seed], np.int32))]
        )
        self._demand_seeded.add(seed)  # after publish: readers of the set
        return True                    # must find the slice materialized

    def demand_query(self, bounds: dict) -> np.ndarray:
        """Answer one bound query through the demanded slice.

        ``bounds`` must bind every column of the transform's adornment with
        a point constant (extra bounds on free columns pass through as
        ordinary filters).  Constants outside the active domain match
        nothing and are answered empty *without* seeding — seeding them
        would force a domain-growth rebuild for a provably empty result.
        The read pins the epoch the seed's transaction published and waits
        on its event, as every read does.
        """
        t = self.demand
        if t is None:
            raise RuntimeError("not a demand-specialized instance")
        seed = tuple(int(bounds[c]) for c in t.bound_cols)
        if any(v < 0 or v >= self.domain for v in seed):
            return np.zeros(
                (0, self.plan.program.arity_of(t.answer_rel)), np.int32
            )
        self.seed_demand(seed)
        return self.query(t.answer_rel, where=bounds)

    # -- writes --------------------------------------------------------------

    _MAX_LOG = 1024          # bounded: serving runs forever
    _OP_ALIAS = {"insert": "insert", "delete": "delete", "retract": "delete"}

    def normalize_txn_ops(self, ops) -> list[tuple[str, str, np.ndarray]]:
        """Validate one transaction's operations; returns ``[(op, rel, rows)]``.

        Checks — all before anything touches the store:

        * the transaction has at least one operation;
        * every ``op`` is ``insert``/``delete`` (``retract`` aliases
          ``delete``) and every ``rel`` an EDB relation of this program;
        * payloads are integer-typed, match the relation's arity, and hold
          no negative constants;
        * no row is both inserted and retracted by the same transaction (a
          transaction is unordered, so the pair is rejected).

        Raises ``KeyError``/``ValueError``; the server's ``tx.submit()``
        wraps these in a :class:`~repro_torch.serve_datalog.errors.RequestError`.
        """
        items = list(ops)
        if not items:
            raise ValueError("empty transaction: no operations")
        out: list[tuple[str, str, np.ndarray]] = []
        for item in items:
            op, rel, rows = (
                (item.op, item.rel, item.rows) if isinstance(item, TxnOp) else item
            )
            kind = self._OP_ALIAS.get(op)
            if kind is None:
                raise ValueError(
                    f"unknown transaction op {op!r}; use insert/delete/retract"
                )
            if rel not in self.strat.edb:
                raise KeyError(f"{rel!r} is not an EDB relation of this program")
            arity = self.plan.program.arity_of(rel)
            arr = np.asarray(rows)
            if arr.size and arr.dtype.kind not in "iu":
                raise ValueError(
                    f"{rel!r} rows must be integer-typed, got dtype {arr.dtype}"
                )
            # a mismatched column count (2-D) or a flat array that is not
            # exactly one row (1-D) must never be reshape-scrambled into
            # tuples the client never sent
            if arr.size and (
                (arr.ndim >= 2 and arr.shape[-1] != arity)
                or (arr.ndim == 1 and arr.size != arity)
            ):
                raise ValueError(
                    f"payload of shape {arr.shape} does not match "
                    f"{rel!r} arity {arity}"
                )
            if arr.size and (
                int(arr.max()) > np.iinfo(np.int32).max
                or int(arr.min()) < np.iinfo(np.int32).min
            ):
                raise ValueError(
                    f"constants in {rel!r} {kind} batch exceed int32 range"
                )
            if not arr.size:
                arr = np.zeros((0, arity), np.int32)
            elif arr.dtype != np.int32 or arr.ndim != 2:
                arr = arr.astype(np.int32).reshape(-1, arity)
            if len(arr) and int(arr.min()) < 0:
                # negative ids would wrap through dense scatters
                raise ValueError(
                    f"negative constants in {rel!r} {kind} batch (ids must be ≥ 0)"
                )
            out.append((kind, rel, arr))
        kinds_by_rel: dict[str, set[str]] = {}
        for kind, rel, _ in out:
            kinds_by_rel.setdefault(rel, set()).add(kind)
        for rel, seen in kinds_by_rel.items():
            if len(seen) < 2:
                continue
            ins: set = set()
            dels: set = set()
            for kind, r, arr in out:
                if r == rel:
                    (ins if kind == "insert" else dels).update(
                        map(tuple, arr.tolist())
                    )
            both = ins & dels
            if both:
                raise ValueError(
                    f"transaction both inserts and retracts {len(both)} row(s) "
                    f"of {rel!r} (e.g. {sorted(both)[0]}); a transaction is "
                    "unordered, so the pair is rejected — submit two "
                    "transactions to sequence the ops"
                )
        return out

    def _finish_update(self, stats: UpdateStats, t0: float) -> UpdateStats:
        stats.seconds = time.perf_counter() - t0
        self.update_log.append(stats)
        return stats

    def _transactional(self, stats: UpdateStats, apply_fn):
        """Run one update as an MVCC write transaction.

        The writer pins its base epoch, copies its handle map (handles are
        immutable, so a shallow copy is a full private workspace), mutates
        the copy on the writer's stream, and — only on success — publishes
        it as the next epoch with an event recorded after its last kernel.
        On failure nothing is published.  One writer at a time.
        """
        with self._write_lock, self._on_writer_stream():
            base = self.vstore.pin()
            domain0 = self.engine.domain
            try:
                txn = _WriteTxn(
                    base=base,
                    store=dict(base.handles),
                    bm={k: dict(v) for k, v in self._bm.items()},
                    domain=base.domain,
                )
                result = apply_fn(txn)
                if txn.mutated:
                    self._bm = txn.bm
                    stats.epoch = self.vstore.publish(
                        txn.store, txn.domain, meta=txn.bm,
                        writes=frozenset(stats.write_set) or None,
                        ready=self._ready_event(),
                    )
                else:
                    stats.epoch = base.epoch
                return result
            except Exception:
                # publish never happened: readers never saw the txn.  The
                # only engine-global scratch a failed rebuild can leave
                # behind is the domain — restore it for the next writer.
                self.engine.domain = domain0
                raise
            finally:
                base.release()

    def apply_txn(self, ops, deadline_check=None) -> UpdateStats:
        """Apply one transaction atomically; publish exactly one epoch.

        ``ops`` is an iterable of ``(op, rel, rows)`` tuples (or
        :class:`TxnOp`) mixing inserts and retractions over any number of
        EDB relations.  Results are bit-for-bit identical to a from-scratch
        evaluation of the post-transaction EDB.

        ``deadline_check`` (optional zero-arg callable) is invoked between
        strata of the propagation pass; raising from it aborts the
        transaction with nothing published.
        """
        t0 = time.perf_counter()
        norm = self.normalize_txn_ops(ops)
        # per-update engine diagnostics only — unbounded growth otherwise
        self.engine.stats.records = self.engine.stats.records[-self._MAX_LOG:]
        del self.update_log[: -self._MAX_LOG]
        stats = UpdateStats(
            relation=(
                norm[0][1]
                if len(norm) == 1
                else "+".join(dict.fromkeys(rel for _, rel, _ in norm))
            ),
            requested=sum(len(rows) for _, _, rows in norm),
            kind=norm[0][0] if len(norm) == 1 else "txn",
            ops=[OpStats(op, rel, len(rows)) for op, rel, rows in norm],
        )
        if stats.requested == 0:
            stats.epoch = self.epoch
            return self._finish_update(stats, t0)
        with _TRACE.span(
            "txn.apply", "serve",
            kind=stats.kind, relation=stats.relation,
            requested=stats.requested, ops=len(norm),
        ) as sp:
            result = self._transactional(
                stats,
                lambda txn: self._apply_ops(
                    txn, norm, stats, t0, deadline_check
                ),
            )
            sp.set(
                epoch=stats.epoch, inserted=stats.inserted,
                removed=stats.removed, derived=stats.derived,
                retracted=stats.retracted, full_rebuild=stats.full_rebuild,
            )
            return result

    #: Set (by the server's writer loop) to suppress the shims' per-batch
    #: DeprecationWarning when delegation was already warned about at
    #: submission time.
    _quiet_shims = False

    def insert_facts(self, rel: str, rows: np.ndarray) -> UpdateStats:
        """Deprecated: apply one batch of new EDB facts.

        A wrapper over the single-op transaction ``apply_txn([("insert",
        rel, rows)])``.  Use :meth:`apply_txn`.
        """
        if not self._quiet_shims:
            warnings.warn(
                "MaterializedInstance.insert_facts is deprecated; use "
                'apply_txn([("insert", rel, rows)])',
                DeprecationWarning,
                stacklevel=2,
            )
        return self.apply_txn([("insert", rel, rows)])

    def retract_facts(self, rel: str, rows: np.ndarray) -> UpdateStats:
        """Deprecated: apply one batch of EDB deletions (DRed).

        A wrapper over the single-op transaction ``apply_txn([("delete",
        rel, rows)])``.  Use :meth:`apply_txn`.
        """
        if not self._quiet_shims:
            warnings.warn(
                "MaterializedInstance.retract_facts is deprecated; use "
                'apply_txn([("delete", rel, rows)])',
                DeprecationWarning,
                stacklevel=2,
            )
        return self.apply_txn([("delete", rel, rows)])

    def _apply_ops(
        self,
        txn: _WriteTxn,
        norm: list[tuple[str, str, np.ndarray]],
        stats: UpdateStats,
        t0: float,
        deadline_check=None,
    ) -> UpdateStats:
        if deadline_check is not None:
            deadline_check()        # before any storage effect is staged
        if any(
            op == "insert" and len(rows) and int(rows.max()) >= txn.domain
            for op, _, rows in norm
        ):
            self._full_rebuild(txn, norm, stats)
            return self._finish_update(stats, t0)

        store_old = dict(txn.base.handles)  # pre-txn handles for DRed bodies
        delta_parts: dict[str, list] = {}
        nabla_parts: dict[str, list] = {}
        for slot, (op, rel, rows) in zip(stats.ops, norm):
            handle: TupleRelation = txn.store[rel]
            if op == "insert":
                new_handle, d_rows, d_count = handle.insert(rows)
                stats.inserted += d_count
                parts = delta_parts
            else:
                new_handle, d_rows, d_count = handle.delete(rows)
                stats.removed += d_count
                parts = nabla_parts
            slot.applied = d_count
            if d_count == 0:
                continue
            txn.store[rel] = new_handle
            txn.mutated = True
            parts.setdefault(rel, []).append((d_rows, d_count))
        if not txn.mutated:
            return self._finish_update(stats, t0)
        changed = {r: self._merge_views(p, txn.domain) for r, p in delta_parts.items()}
        deleted = {r: self._merge_views(p, txn.domain) for r, p in nabla_parts.items()}
        reads = self._propagate(
            txn, store_old, changed, deleted, stats, deadline_check
        )
        if deadline_check is not None:
            deadline_check()        # last gate: never publish past deadline
        stats.write_set = tuple(
            sorted(
                {slot.rel for slot in stats.ops if slot.applied}
                | set(changed)
                | set(deleted)
            )
        )
        stats.read_set = tuple(sorted(reads | set(stats.write_set)))
        return self._finish_update(stats, t0)

    def _merge_views(self, parts: list, domain: int) -> TupleView:
        """One Δ/∇ view per relation from one or more per-op delta tables
        (disjoint by construction, so the merge is a union), on the device."""
        cap_min = self.engine.config.capacity_min
        if len(parts) == 1:
            rows, count = parts[0]
            return TupleView(rows[: next_bucket(max(count, 1), cap_min)], count, domain)
        data = torch.cat([r[:c] for r, c in parts])
        srt = _sort_pad(data, next_bucket(len(data), cap_min), domain)
        rows, count = _dedup_sorted(srt, domain)
        return TupleView(rows[: next_bucket(count, cap_min)], count, domain)

    def _propagate(
        self,
        txn: _WriteTxn,
        store_old: dict,
        changed: dict[str, TupleView],
        deleted: dict[str, TupleView],
        stats: UpdateStats,
        deadline_check=None,
    ) -> set[str]:
        """One pass over the stratification for a mixed Δ/∇ seed set.

        Each stratum is visited once and handles whatever mix of Δ and ∇
        views reaches it, then hands one net diff downstream.  A transaction
        with no ∇ seeds takes the monotone fast path (retractions surfacing
        mid-pass taint downstream strata to ``full``).  Returns the set of
        relations the visited strata read.
        """
        reads: set[str] = set()
        nonmono: set[str] = set()
        if not deleted:
            for stratum in self.strat.strata:
                if deadline_check is not None:
                    deadline_check()    # stratum boundary: abort point
                mode, kinds, refs = self._update_mode(txn, stratum, changed, nonmono)
                if mode == "skip":
                    continue
                reads |= refs
                with _TRACE.span(
                    "stratum", "serve",
                    index=stratum.index, resident=stratum.index in txn.bm,
                    delta_in=sum(
                        v.count for r, v in changed.items() if r in refs
                    ) if _TRACE.enabled else 0,
                ) as sp:
                    if mode == "delta" and stratum.index in txn.bm and (
                        self._bm_applies(txn, stratum, changed)
                    ):
                        iters, derived = self._bitmatrix_delta(txn, stratum, changed)
                        stats.modes[stratum.index] = "bitmatrix"
                    elif mode == "delta":
                        iters, derived = self._delta_stratum(
                            txn, stratum, changed, nonmono, kinds
                        )
                        stats.modes[stratum.index] = "delta"
                    else:
                        iters, derived = self._full_stratum(
                            txn, stratum, changed, nonmono
                        )
                        stats.modes[stratum.index] = "full"
                    sp.set(
                        mode=stats.modes[stratum.index],
                        iterations=iters, derived=derived,
                    )
                    est = self._stratum_estimate(stratum.index)
                    if est is not None:
                        sp.set(est_rows=est)
                stats.iterations[stratum.index] = iters
                stats.derived += derived
                stats.derived_by_stratum[stratum.index] = derived
            return reads

        for stratum in self.strat.strata:
            if deadline_check is not None:
                deadline_check()        # stratum boundary: abort point
            mode, kinds, refs = self._retract_mode(
                txn, stratum, deleted, changed, nonmono
            )
            if mode == "skip":
                continue
            reads |= refs
            with _TRACE.span(
                "stratum", "serve",
                index=stratum.index, resident=stratum.index in txn.bm,
                delta_in=sum(
                    v.count for r, v in changed.items() if r in refs
                ) if _TRACE.enabled else 0,
                nabla_in=sum(
                    v.count for r, v in deleted.items() if r in refs
                ) if _TRACE.enabled else 0,
            ) as sp:
                if mode == "delta" and stratum.index in txn.bm and (
                    self._bm_applies(txn, stratum, changed)
                ):
                    iters, derived = self._bitmatrix_delta(txn, stratum, changed)
                    stats.modes[stratum.index] = "bitmatrix"
                elif mode == "delta":
                    iters, derived = self._delta_stratum(
                        txn, stratum, changed, nonmono, kinds
                    )
                    stats.modes[stratum.index] = "delta"
                elif mode == "dred":
                    iters, net_del, net_add = self.engine.dred_stratum(
                        self.strat, stratum, txn.store, store_old,
                        deleted, changed, kinds,
                        self.plan.groups_for(stratum.index),
                    )
                    deleted.update(net_del)
                    changed.update(net_add)
                    stats.modes[stratum.index] = "dred"
                    stats.retracted += sum(v.count for v in net_del.values())
                    derived = sum(v.count for v in net_add.values())
                else:
                    iters, n_add, n_del = self._full_stratum_diff(
                        txn, stratum, deleted, changed
                    )
                    stats.modes[stratum.index] = "full"
                    stats.retracted += n_del
                    derived = n_add
                stats.derived += derived
                sp.set(
                    mode=stats.modes[stratum.index], iterations=iters,
                    derived=derived,
                )
                est = self._stratum_estimate(stratum.index)
                if est is not None:
                    sp.set(est_rows=est)
            stats.iterations[stratum.index] = iters
            stats.derived_by_stratum[stratum.index] = derived
        return reads

    def _stratum_estimate(self, index: int) -> float | None:
        est = getattr(self, "plan_estimate", None)
        if est is None:
            return None
        se = est.stratum(index)
        return se.est_rows if se is not None else None

    # -- update-mode selection ----------------------------------------------

    def _update_mode(
        self,
        txn: _WriteTxn,
        stratum: Stratum,
        changed: dict[str, TupleView],
        nonmono: set[str],
    ) -> tuple[str, dict[str, str] | None, set[str]]:
        """(mode, handle kinds, body refs) for the insert path."""
        refs = {a.pred for r in stratum.rules for a in r.atoms}
        if not refs & (set(changed) | nonmono):
            return "skip", None, refs
        if refs & nonmono:
            return "full", None, refs  # upstream retractions: deltas unavailable
        if any(
            a.negated and a.pred in changed
            for r in stratum.rules
            for a in r.atoms
        ):
            return "full", None, refs  # growth of a negated relation retracts
        kinds = self.engine._init_handles(self.strat, stratum, txn.store, fresh=False)
        if any(
            r.has_aggregate and kinds.get(r.head_pred) != "dense_agg"
            for r in stratum.rules
        ):
            return "full", None, refs  # tuple-path aggregates overwrite groups
        return "delta", kinds, refs

    def _retract_mode(
        self,
        txn: _WriteTxn,
        stratum: Stratum,
        deleted: dict[str, TupleView],
        changed: dict[str, TupleView],
        nonmono: set[str],
    ) -> tuple[str, dict[str, str] | None, set[str]]:
        """Per-stratum dispatch for the retraction path.

        ``dred`` — tuple-backed, aggregate-free, no negation over a touched
        relation.  ``delta``/``bitmatrix`` — only insertions reach this
        stratum.  ``full`` — deletions reach an aggregate, a dense handle, a
        negated relation, or a PBME-resident stratum (``eligible_plan``
        refuses decremental plans).
        """
        refs = {a.pred for r in stratum.rules for a in r.atoms}
        touched = set(deleted) | set(changed)
        if not refs & (touched | nonmono):
            return "skip", None, refs
        if refs & nonmono:
            return "full", None, refs
        if any(
            a.negated and a.pred in touched
            for r in stratum.rules
            for a in r.atoms
        ):
            return "full", None, refs
        kinds = self.engine._init_handles(self.strat, stratum, txn.store, fresh=False)
        if not refs & set(deleted):
            if any(
                r.has_aggregate and kinds.get(r.head_pred) != "dense_agg"
                for r in stratum.rules
            ):
                return "full", None, refs
            return "delta", kinds, refs
        if any(r.has_aggregate for r in stratum.rules):
            return "full", None, refs
        if any(kinds[p] != "tuple" for p in stratum.preds):
            return "full", None, refs
        if stratum.index in txn.bm:
            # decremental closure is unsupported: a resident PBME stratum
            # recomputes from scratch
            return "full", None, refs
        return "dred", kinds, refs

    def _bm_applies(
        self, txn: _WriteTxn, stratum: Stratum, changed: dict[str, TupleView]
    ) -> bool:
        refs = {a.pred for r in stratum.rules for a in r.atoms}
        return refs & set(changed) == {txn.bm[stratum.index]["plan"].edb}

    # -- the update paths ----------------------------------------------------

    def _bitmatrix_delta(
        self, txn: _WriteTxn, stratum: Stratum, changed: dict[str, TupleView]
    ):
        """The PBME increment, entirely on the device: the new edges are
        packed there, the increment runs the ``bitmm`` kernel on the
        compacted frontier, and the new closure pairs go from matrix to
        sorted rows on the device and merge into the stored IDB."""
        st = txn.bm[stratum.index]
        plan = st["plan"]
        view = changed[plan.edb]
        d_arc = edges_to_bitmatrix(view.rows[: view.count], txn.domain)
        st["arc"] = st["arc"] | d_arc
        m_old = st["m"]
        fix = tc_increment if plan.kind == "tc" else sg_increment
        m_new, iters = fix(m_old, st["arc"], d_arc, txn.domain)
        st["m"] = m_new
        new_pairs = m_new & ~m_old
        count = int(popcount(new_pairs))
        if count:
            pairs = bitmatrix_to_rows(new_pairs, txn.domain)   # sorted rows
            cap = next_bucket(count, self.engine.config.capacity_min)
            dr = torch.full((cap, 2), SENTINEL, dtype=torch.int32, device=pairs.device)
            dr[:count] = pairs
            txn.store[plan.idb] = txn.store[plan.idb].merge(dr, count)
            changed[plan.idb] = TupleView(dr, count, txn.domain)
        return iters, count

    def _delta_stratum(
        self,
        txn: _WriteTxn,
        stratum: Stratum,
        changed: dict[str, TupleView],
        nonmono: set[str],
        handles: dict[str, str],
    ):
        eng = self.engine
        dsd_state = {p: DSDState(alpha=eng.config.alpha) for p in stratum.preds}
        deltas: dict[str, TupleView | None] = {p: None for p in stratum.preds}
        deltas.update(changed)          # external Δ views, read by ingest variants
        snapshots = {p: self._handle_snapshot(txn.store, p) for p in stratum.preds}

        groups = ingest_variants(stratum, set(changed))
        for pred in stratum.preds:
            # same "rule" span the engine's loop emits, so profile trees see
            # the ingest pass (iteration 0)
            with _TRACE.span(
                "rule", "engine",
                pred=pred, stratum=stratum.index, iteration=0,
                variants=len(groups[pred]), ingest=True,
            ) as rule_span:
                rec = eng._eval_idb_iteration(
                    self.strat, stratum, txn.store, handles, deltas, dsd_state,
                    pred, groups[pred], 0,
                )
                rule_span.set(
                    candidates=rec.candidates, delta=rec.delta,
                    full=rec.full, dsd=rec.dsd_strategy,
                )
            eng.stats.records.append(rec)
        if stratum.recursive:
            eng._seminaive_loop(
                self.strat, stratum, txn.store, handles, deltas, dsd_state,
                self.plan.groups_for(stratum.index), start_iteration=1,
            )
        iters = eng.stats.iterations.get(stratum.index, 1) if stratum.recursive else 1

        derived = 0
        for pred in stratum.preds:
            snap = snapshots[pred]
            if snap[0] == "dense_agg":
                # A MIN/MAX value *improvement* on an already-present key is a
                # logical retraction of the old (key, value) tuple — downstream
                # consumers holding the old tuple must recompute
                h = txn.store[pred]
                improved = h.values != snap[1]
                overwritten = improved & (snap[1] != h.absent)
                if bool(overwritten.any()):
                    nonmono.add(pred)
                    derived += int(improved.sum())
                    continue
            view = self._delta_since(txn, pred, snap)
            if view is not None:
                changed[pred] = view
                derived += view.count
        return iters, derived

    def _full_stratum(
        self,
        txn: _WriteTxn,
        stratum: Stratum,
        changed: dict[str, TupleView],
        nonmono: set[str],
    ):
        iters, derived, _ = self._recompute_stratum(
            txn, stratum, changed, nonmono=nonmono
        )
        return iters, derived

    def _full_stratum_diff(
        self,
        txn: _WriteTxn,
        stratum: Stratum,
        deleted: dict[str, TupleView],
        changed: dict[str, TupleView],
    ) -> tuple[int, int, int]:
        return self._recompute_stratum(txn, stratum, changed, deleted=deleted)

    def _recompute_stratum(
        self,
        txn: _WriteTxn,
        stratum: Stratum,
        changed: dict[str, TupleView],
        nonmono: set[str] | None = None,
        deleted: dict[str, TupleView] | None = None,
    ) -> tuple[int, int, int]:
        """Recompute a stratum from scratch; propagate the old-vs-new diff.

        Additions always become Δ views in ``changed``.  Retractions follow
        the caller's policy: the insert path passes ``nonmono`` and taints
        every downstream stratum; the retraction path passes ``deleted`` and
        hands explicit ∇ views downstream.  Returns ``(iterations, n_added,
        n_removed)``.
        """
        old = {p: txn.store.get(p) for p in stratum.preds}
        for p in stratum.preds:
            txn.store.pop(p, None)
        self.engine._eval_stratum(self.strat, stratum, txn.store)
        n_add = n_del = 0
        for p in stratum.preds:
            fresh, gone = self._diff(old[p], txn.store.get(p), txn.domain)
            n_add += fresh.count if fresh is not None else 0
            n_del += gone.count if gone is not None else 0
            if gone is not None and deleted is not None:
                deleted[p] = gone
            if gone is not None and nonmono is not None:
                nonmono.add(p)      # retractions: taint downstream strata
            elif fresh is not None:
                changed[p] = fresh
            if stratum.index in txn.bm and txn.bm[stratum.index]["plan"].idb == p:
                self._refresh_bitmatrix(txn, stratum.index)
        return self.engine.stats.iterations.get(stratum.index, 1), n_add, n_del

    def _diff(self, old_h, new_h, domain: int):
        """(added, removed) views of one relation across a recompute, or
        ``None`` for an empty side.  Two sorted tuple tables are diffed on the
        device (a closure of 10^8 rows never visits the host); dense handles,
        at most domain-sized, go through the host."""
        cap_min = self.engine.config.capacity_min
        if isinstance(old_h, TupleRelation) and isinstance(new_h, TupleRelation):
            out = []
            for src, dst in ((new_h, old_h), (old_h, new_h)):
                if src.count == 0:
                    out.append(None)
                    continue
                rows, count, _ = set_difference(
                    src.rows, src.count, dst.rows, dst.count, domain, DSDState()
                )
                out.append(
                    TupleView(rows[: next_bucket(count, cap_min)], count, domain)
                    if count else None
                )
            return tuple(out)
        old_set = set(map(tuple, old_h.to_numpy().tolist())) if old_h is not None else set()
        new_set = set(map(tuple, new_h.to_numpy().tolist())) if new_h is not None else set()
        fresh, gone = sorted(new_set - old_set), sorted(old_set - new_set)
        return (
            self._view_from_numpy(np.array(fresh, np.int32), domain) if fresh else None,
            self._view_from_numpy(np.array(gone, np.int32), domain) if gone else None,
        )

    def _full_rebuild(
        self,
        txn: _WriteTxn,
        norm: list[tuple[str, str, np.ndarray]],
        stats: UpdateStats,
    ) -> None:
        """Domain growth: dense state is sized by the active domain → rebuild.

        Every op of the transaction is applied to the host-side EDB and the
        program re-evaluated from scratch; the rebuilt fixpoint becomes the
        transaction's next-epoch state — still exactly one epoch.
        """
        stats.full_rebuild = True
        _TRACE.instant("full_rebuild", "serve", relation=stats.relation)
        old_counts = {
            p: getattr(txn.store.get(p), "count", 0) for p in self.strat.idb
        }
        edb = {name: self._rows_of(txn.store, name) for name in self.strat.edb}
        for slot, (op, rel, rows) in zip(stats.ops, norm):
            cur = set(map(tuple, edb[rel].tolist()))
            batch = set(map(tuple, rows.tolist()))
            if op == "insert":
                slot.applied = len(batch - cur)
                stats.inserted += slot.applied
                cur |= batch
            else:
                slot.applied = len(batch & cur)
                stats.removed += slot.applied
                cur -= batch
            arity = self.plan.program.arity_of(rel)
            edb[rel] = (
                np.array(sorted(cur), np.int32)
                if cur
                else np.zeros((0, arity), np.int32)
            )
        self.engine.run(self.plan.program, edb, strat=self.plan.strat,
                        return_numpy=False)
        txn.store = self.engine.take_store()
        txn.domain = self.engine.domain
        txn.mutated = True
        self.cache.warm(self.plan, txn.domain, buckets=self._hot_buckets(txn.store),
                        device=self.device)
        txn.bm = self._init_bitmatrix_state(txn.store, txn.domain)
        for p in self.strat.idb:
            new_count = getattr(txn.store.get(p), "count", 0)
            stats.derived += max(new_count - old_counts[p], 0)
            stats.retracted += max(old_counts[p] - new_count, 0)
        stats.write_set = tuple(sorted(set(self.strat.edb) | set(self.strat.idb)))
        stats.read_set = stats.write_set
        # the domain changed: every size the EXPLAIN estimate was built on
        # is stale — recompute against the rebuilt state
        self.plan_estimate = self._make_plan_estimate(
            txn.store, txn.domain, txn.bm
        )
        self.engine.estimates = self.plan_estimate

    # -- delta bookkeeping -----------------------------------------------------

    def _handle_snapshot(self, store: dict, pred: str):
        h = store.get(pred)
        if isinstance(h, TupleRelation):
            return ("tuple", h.rows, h.count)
        if isinstance(h, DenseSetRelation):
            return ("dense_set", h.member)
        if isinstance(h, DenseAggRelation):
            return ("dense_agg", h.values)
        return ("absent",)

    def _delta_since(self, txn: _WriteTxn, pred: str, snap) -> TupleView | None:
        h = txn.store.get(pred)
        cap_min = self.engine.config.capacity_min
        if snap[0] == "tuple":
            _, old_rows, old_count = snap
            if h.count == old_count:
                return None
            rows, count, _ = set_difference(
                h.rows, h.count, old_rows, old_count, txn.domain, DSDState()
            )
            if count == 0:
                return None
            return TupleView(
                rows[: next_bucket(max(count, 1), cap_min)], count, txn.domain
            )
        if snap[0] == "dense_set":
            mask = h.member & ~snap[1]
            count = int(mask.sum())
            if count == 0:
                return None
            view = DenseSetRelation(h.name, h.n, h.member, mask, h.count, count)
            rows, _ = view.delta_tuples(next_bucket(count, cap_min))
            return TupleView(rows, count, txn.domain)
        if snap[0] == "dense_agg":
            mask = h.values != snap[1]
            count = int(mask.sum())
            if count == 0:
                return None
            view = DenseAggRelation(
                h.name, h.n, h.op, h.values, mask, h.count, count
            )
            rows, _ = view.delta_tuples(next_bucket(count, cap_min))
            return TupleView(rows, count, txn.domain)
        # pred absent before this stratum ran: everything it now holds is new
        if h is None:
            return None
        data = h.to_numpy()
        return self._view_from_numpy(data, txn.domain) if len(data) else None

    def _view_from_numpy(self, data: np.ndarray, domain: int) -> TupleView:
        cap = next_bucket(len(data), self.engine.config.capacity_min)
        rows = _sort_pad(
            torch.as_tensor(data.astype(np.int32), device=self.device), cap, domain
        )
        return TupleView(rows, len(data), domain)

    def _refresh_bitmatrix(self, txn: _WriteTxn, stratum_index: int) -> None:
        st = txn.bm[stratum_index]
        st["arc"] = self._packed(txn.store[st["plan"].edb], txn.domain)
        st["m"] = self._packed(txn.store[st["plan"].idb], txn.domain)
