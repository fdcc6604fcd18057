"""The RecStep interpreter: Algorithm 1 on PyTorch (paper §4, §5).

Host Python owns loop control (exactly as the paper's interpreter does); every
relational operator runs on the engine's device.  Per recursive stratum, per
iteration and per IDB ``R``:

    R_t  ← uieval(rules(R, s))          # UIE: ONE fused evaluation of all
                                        #       delta-variants deriving R
    analyze(R_t)                        # OOF: scalar counts only
    R_δ  ← dedup(R_t)                   # FAST-DEDUP analogue (compact keys)
    ΔR   ← R_δ − R                      # DSD: OPSD/TPSD per cost model
    R    ← R ⊎ ΔR                       # sorted merge (EOST: stays on device)

Dense backends (the paper's "specialized data structures"): unary recursive
IDBs → bit-vector; recursive MIN/MAX aggregates → dense value tables; dense
binary TC/SG-shaped strata → PBME bit-matrix (see ``bitmatrix.py``), whose
products run the hand-written CUDA kernels on a CUDA device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.aggregates import eval_expr, groupby_aggregate
from repro_torch.core.analyzer import Stratification, Stratum, analyze
from repro_torch.core.ast import Agg, Atom, Program, Var
from repro_torch.core.bitmatrix import eligible_plan
from repro_torch.core.joins import (
    Bindings,
    antijoin,
    apply_comparison,
    init_bindings,
    join_counts,
    join_materialize,
    order_atoms,
    project_head,
)
from repro_torch.core.relation import (
    DenseAggRelation,
    DenseSetRelation,
    TupleRelation,
    _dedup_sorted,
    _key_column,
    _sort_pad,
    _sorted_by_col,
    next_bucket,
)
from repro_torch.core.seminaive import (
    NABLA,
    RuleVariant,
    delta_variants,
    deletion_variants,
    rederive_seed_variants,
)
from repro_torch.core.setdiff import DSDState, set_difference
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.relational.sort import SENTINEL

# --------------------------------------------------------------------------
# configuration & statistics
# --------------------------------------------------------------------------


@dataclass
class EngineConfig:
    enable_uie: bool = True          # Unified IDB Evaluation
    enable_oof: bool = True          # per-iteration stats-driven planning
    dsd: str = "dynamic"             # dynamic | opsd | tpsd
    enable_eost: bool = True         # off: simulate per-iteration commits
    enable_dense: bool = True        # dense set/agg specializations
    backend: str = "auto"            # auto | tuple | bitmatrix
    max_bitmatrix_n: int = 1 << 15   # PBME memory gate (paper §5.3)
    alpha: float = 4.0               # DSD cost-model α (see setdiff.calibrate_alpha)
    max_iters: int = 1_000_000
    capacity_min: int = 128
    checkpoint_every: int = 0        # fixpoint checkpoint cadence (0 = off)
    checkpoint_dir: str | None = None
    eost_spill_dir: str | None = None  # EOST-off ablation writes here


@dataclass
class IterationRecord:
    stratum: int
    iteration: int
    idb: str
    candidates: int = 0
    deduped: int = 0
    delta: int = 0
    full: int = 0
    dsd_strategy: str = "-"
    seconds: float = 0.0


@dataclass
class EvalStats:
    records: list[IterationRecord] = field(default_factory=list)
    iterations: dict[int, int] = field(default_factory=dict)
    backend_used: dict[str, str] = field(default_factory=dict)
    total_seconds: float = 0.0
    # per-stratum actuals: wall time and final per-IDB row counts
    stratum_seconds: dict[int, float] = field(default_factory=dict)
    stratum_rows: dict[int, dict[str, int]] = field(default_factory=dict)

    def total_iterations(self) -> int:
        return sum(self.iterations.values())


# --------------------------------------------------------------------------
# relation views (uniform join interface over physical representations)
# --------------------------------------------------------------------------


class TupleView:
    """Read view for the join machinery: rows (sorted by col 0) + count."""

    def __init__(self, rows: torch.Tensor, count: int, domain: int):
        self.rows = rows
        self.count = count
        self.domain = domain
        self._by_col: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def sorted_by(self, col: int) -> tuple[torch.Tensor, torch.Tensor]:
        if col == 0:
            return self.rows, self.rows[:, 0]
        if col not in self._by_col:
            self._by_col[col] = _sorted_by_col(self.rows, col)
        return self._by_col[col]


def _empty_view(arity: int, domain: int, device: torch.device) -> TupleView:
    return TupleView(
        torch.full((1, arity), SENTINEL, dtype=torch.int32, device=device), 0, domain
    )


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------


class Engine:
    #: Plan-time cardinality estimates (``repro_torch.obs.explain.
    #: PlanEstimate``), attached by the serving layer at plan admission; the
    #: engine only reads ``est_rows`` off it to annotate stratum spans.
    estimates = None

    def __init__(self, config: EngineConfig | None = None, device=None):
        self.config = config or EngineConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch.Engine runs on CUDA by default and no CUDA device is "
                'available; pass device="cpu" to run on the CPU'
            )
        self.stats = EvalStats()

    # -- public API --------------------------------------------------------

    def run(
        self,
        program: Program | str,
        edb: dict[str, np.ndarray],
        resume_from: str | None = None,
        strat: Stratification | None = None,
        return_numpy: bool = True,
    ) -> dict[str, np.ndarray] | None:
        """Evaluate ``program`` over ``edb`` to a fixpoint.

        Returns every IDB relation as numpy rows; ``return_numpy=False``
        keeps the fixpoint on the device (see :meth:`take_store`).
        ``resume_from`` names a directory of checkpoints written with
        ``EngineConfig.checkpoint_every``/``checkpoint_dir`` (by either
        package): the newest valid one is loaded onto the engine's device
        and evaluation continues from its stratum and iteration.
        """
        if isinstance(program, str):
            from repro_torch.core.parser import parse

            program = parse(program)
        if strat is None:
            strat = analyze(program)
        t_start = time.perf_counter()

        domain = 1
        for arr in edb.values():
            arr = np.asarray(arr)
            if arr.size:
                domain = max(domain, int(arr.max()) + 1)
        self.domain = domain

        store: dict[str, Any] = {}
        for name in strat.edb:
            if name not in edb:
                raise KeyError(f"missing EDB relation {name!r}")
            store[name] = TupleRelation.from_numpy(name, edb[name], domain, self.device)

        start_stratum, start_iter = 0, 0
        if resume_from is not None:
            start_stratum, start_iter, store = self._load_fixpoint(
                resume_from, strat, store
            )

        with _TRACE.span(
            "engine.run", "engine", strata=len(strat.strata), domain=domain
        ):
            for stratum in strat.strata:
                if stratum.index < start_stratum:
                    continue
                it0 = start_iter if stratum.index == start_stratum else 0
                self._eval_stratum(strat, stratum, store, start_iteration=it0)

        self.stats.total_seconds = time.perf_counter() - t_start
        self.strat = strat
        self.store = store
        if not return_numpy:
            return None
        with _TRACE.span("device.sync", "engine", what="to_numpy"):
            return self._to_numpy(strat, program, store)

    def take_store(self) -> dict[str, Any]:
        """Hand off the materialized handle map to the caller (leaving the
        engine with an empty one, so it keeps no superseded handles alive)."""
        store, self.store = self.store, {}
        return store

    @staticmethod
    def _to_numpy(
        strat: Stratification, program: Program, store: dict[str, Any]
    ) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        for name in strat.idb:
            out[name] = store[name].to_numpy() if name in store else np.zeros(
                (0, program.arity_of(name)), np.int32
            )
        return out

    # -- stratum evaluation -------------------------------------------------

    def _estimated_rows(self, stratum: Stratum) -> float | None:
        """Plan-time estimate for this stratum, if the serving layer set one."""
        est = self.estimates
        if est is None:
            return None
        se = est.stratum(stratum.index)
        return se.est_rows if se is not None else None

    def _note_stratum_actuals(
        self, stratum: Stratum, store: dict[str, Any], t0: float
    ) -> dict[str, int]:
        rows = {
            p: int(getattr(store.get(p), "count", 0)) for p in stratum.preds
        }
        self.stats.stratum_seconds[stratum.index] = time.perf_counter() - t0
        self.stats.stratum_rows[stratum.index] = rows
        return rows

    def _eval_stratum(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        start_iteration: int = 0,
    ) -> None:
        cfg = self.config
        t0 = time.perf_counter()

        # PBME: dense binary TC/SG-shaped strata on the bit-matrix backend
        plan = eligible_plan(stratum, self.domain, cfg)
        if plan is not None:
            with _TRACE.span(
                "stratum.eval", "engine",
                stratum=stratum.index, backend="bitmatrix",
            ) as sp:
                plan.execute(store, self)
                rows = self._note_stratum_actuals(stratum, store, t0)
                sp.set(
                    iterations=plan.iterations,
                    rows=sum(rows.values()),
                    seconds=self.stats.stratum_seconds[stratum.index],
                )
                est = self._estimated_rows(stratum)
                if est is not None:
                    sp.set(est_rows=est)
            self.stats.backend_used[stratum.preds[0]] = "bitmatrix"
            self.stats.iterations[stratum.index] = plan.iterations
            return

        groups = delta_variants(stratum)
        handles = self._init_handles(strat, stratum, store, fresh=start_iteration == 0)
        for p in stratum.preds:
            self.stats.backend_used[p] = handles[p]
        dsd_state = {p: DSDState(alpha=cfg.alpha) for p in stratum.preds}
        deltas: dict[str, TupleView | None] = {p: None for p in stratum.preds}
        if start_iteration > 0 and getattr(self, "_resume_deltas", None):
            # mid-stratum resume: the checkpoint's live Δ views drive the
            # next iteration's delta variants exactly as before the checkpoint
            deltas.update(
                {p: v for p, v in self._resume_deltas.items() if p in deltas}
            )
            self._resume_deltas = None
        with _TRACE.span(
            "stratum.eval", "engine",
            stratum=stratum.index, backend="tuple",
            recursive=stratum.recursive,
        ) as sp:
            self._seminaive_loop(
                strat, stratum, store, handles, deltas, dsd_state, groups,
                start_iteration=start_iteration,
            )
            rows = self._note_stratum_actuals(stratum, store, t0)
            sp.set(
                iterations=self.stats.iterations.get(stratum.index, 0),
                rows=sum(rows.values()),
                seconds=self.stats.stratum_seconds[stratum.index],
            )
            est = self._estimated_rows(stratum)
            if est is not None:
                sp.set(est_rows=est)

    def _seminaive_loop(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        handles: dict[str, str],
        deltas: dict[str, TupleView | None],
        dsd_state: dict[str, DSDState],
        groups: dict[str, list[RuleVariant]],
        start_iteration: int = 0,
    ) -> None:
        """The per-stratum iteration loop of Algorithm 1, resumable.

        With ``start_iteration > 0`` and externally seeded ``deltas``
        (incremental view maintenance: new EDB facts become ΔR and iteration
        continues from where the fixpoint left off) only the Δ-variants
        fire, never the base rules.
        """
        cfg = self.config
        iteration = start_iteration
        while True:
            any_delta = False
            it_span = _TRACE.span(
                "iteration", "engine", stratum=stratum.index, iteration=iteration
            )
            it_deltas: dict[str, int] = {}
            with it_span:
                for pred in stratum.preds:
                    t0 = time.perf_counter()
                    variants = [
                        v
                        for v in groups[pred]
                        if (v.delta_idx is None) == (iteration == 0)
                    ]
                    if not variants and iteration > 0:
                        # pred only has base rules — no recursion on it
                        self._note(stratum, iteration, pred, 0, 0, 0, store, t0)
                        continue
                    with _TRACE.span(
                        "rule", "engine",
                        pred=pred, stratum=stratum.index,
                        iteration=iteration, variants=len(variants),
                    ) as rule_span:
                        rec = self._eval_idb_iteration(
                            strat, stratum, store, handles, deltas, dsd_state,
                            pred, variants, iteration,
                        )
                        rule_span.set(
                            candidates=rec.candidates, delta=rec.delta,
                            full=rec.full, dsd=rec.dsd_strategy,
                        )
                    rec.seconds = time.perf_counter() - t0
                    self.stats.records.append(rec)
                    if _TRACE.enabled:
                        it_deltas[pred] = rec.delta
                    if rec.delta > 0:
                        any_delta = True
                it_span.set(deltas=it_deltas, any_delta=any_delta)
            iteration += 1
            self.stats.iterations[stratum.index] = iteration

            if not cfg.enable_eost:
                self._simulate_commit(stratum, store)
            if (
                cfg.checkpoint_every
                and cfg.checkpoint_dir
                and iteration % cfg.checkpoint_every == 0
            ):
                self._save_fixpoint(
                    cfg.checkpoint_dir, stratum.index, iteration, store, deltas
                )

            if not stratum.recursive:
                break                                    # Alg. 1 line 15
            if iteration > 0 and not any_delta:
                break                                    # fixpoint
            if iteration >= cfg.max_iters:
                raise RuntimeError("max_iters exceeded without fixpoint")

    def _note(self, stratum, iteration, pred, cand, dd, dl, store, t0):
        h = store.get(pred)
        full = getattr(h, "count", 0)
        self.stats.records.append(
            IterationRecord(
                stratum.index, iteration, pred, cand, dd, dl, full,
                "-", time.perf_counter() - t0,
            )
        )

    def _init_handles(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        fresh: bool = True,
    ) -> dict[str, str]:
        """Choose the physical representation per IDB (dense specializations).

        ``fresh=False`` keeps a handle the store already holds (the serving
        layer resumes a materialized stratum) and only reports its kind.
        """
        cfg = self.config
        kinds: dict[str, str] = {}
        for pred in stratum.preds:
            arity = strat.pred_arity(pred)
            rules = stratum.rules_for(pred)
            agg_ops = {
                t.op
                for r in rules
                for t in r.head_terms
                if isinstance(t, Agg)
            }
            dense_agg = (
                cfg.enable_dense
                and stratum.recursive
                and arity == 2
                and agg_ops in ({"MIN"}, {"MAX"})
                and all(
                    len(r.head_terms) == 2
                    and isinstance(r.head_terms[0], Var)
                    and isinstance(r.head_terms[1], Agg)
                    for r in rules
                )
            )
            dense_set = (
                cfg.enable_dense and stratum.recursive and arity == 1 and not agg_ops
            )
            if dense_agg:
                kinds[pred] = "dense_agg"
                if fresh or pred not in store:
                    store[pred] = DenseAggRelation.empty(
                        pred, self.domain, next(iter(agg_ops)), self.device
                    )
            elif dense_set:
                kinds[pred] = "dense_set"
                if fresh or pred not in store:
                    store[pred] = DenseSetRelation.empty(pred, self.domain, self.device)
            else:
                kinds[pred] = "tuple"
                if fresh or pred not in store:
                    store[pred] = TupleRelation.empty(
                        pred, arity, self.domain, self.device, cfg.capacity_min
                    )
        self._kinds = kinds
        return kinds

    # -- one (IDB, iteration) ------------------------------------------------

    def _eval_idb_iteration(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        handles: dict[str, str],
        deltas: dict[str, TupleView | None],
        dsd_state: dict[str, DSDState],
        pred: str,
        variants: list[RuleVariant],
        iteration: int,
    ) -> IterationRecord:
        cfg = self.config
        kind = handles[pred]
        rec = IterationRecord(stratum.index, iteration, pred, 0, 0, 0, 0)

        # ---- uieval: evaluate every variant's body ----
        buffers = []
        for var in variants:
            res = self._eval_variant(strat, stratum, store, deltas, var)
            if res is not None:
                buffers.append(res)

        if kind in ("dense_agg", "dense_set"):
            # Δ semantics: facts live in Δ for exactly one iteration.  With
            # no candidates this iteration, Δ must CLEAR (a stale Δ would
            # re-fire forever — dead-end frontiers); with several buffers,
            # Δ is the UNION of per-update improvements.
            handle = store[pred]
            new = handle
            delta_acc = torch.zeros(handle.n, dtype=torch.bool, device=self.device)
            for bind, _valid, rule in buffers:
                keys = torch.clamp(bind.cols[rule.head_terms[0]], 0, handle.n - 1)
                if kind == "dense_agg":
                    agg = rule.head_terms[1]
                    assert isinstance(agg, Agg)
                    new = new.update(keys, eval_expr(agg.arg, bind), bind.valid)
                else:
                    new = new.update(keys, bind.valid)
                delta_acc = delta_acc | new.delta
            if kind == "dense_agg":
                new = DenseAggRelation(
                    new.name, new.n, new.op, new.values, delta_acc,
                    new.count, int(delta_acc.sum()),
                )
            else:
                new = DenseSetRelation(
                    new.name, new.n, new.member, delta_acc,
                    new.count, int(delta_acc.sum()),
                )
            store[pred] = new
            deltas[pred] = None  # dense deltas materialized on demand
            rec.candidates = sum(int(b[1].sum()) for b in buffers)
            rec.delta, rec.full = new.delta_count, new.count
            return rec

        # ---- tuple path: UIE concat → dedup → DSD → merge ----
        handle: TupleRelation = store[pred]
        if not buffers:
            deltas[pred] = _empty_view(handle.arity, self.domain, self.device)
            rec.full = handle.count
            return rec

        if cfg.enable_uie:
            cand = torch.cat([b[0] for b in buffers], dim=0)
        else:
            # ablation: dedup each subquery separately, then re-union (the
            # paper's "Individual IDB Evaluation" with temp tables, Fig. 4)
            parts = []
            for rows, _valid, _rule in buffers:
                cap_i = next_bucket(rows.shape[0], cfg.capacity_min)
                srt = _sort_pad(rows, cap_i, self.domain)
                dd, _ = _dedup_sorted(srt, self.domain)
                parts.append(dd)
            cand = torch.cat(parts, dim=0)
        rec.candidates = int((cand[:, 0] != SENTINEL).sum())

        cap = next_bucket(cand.shape[0], cfg.capacity_min)
        cand = _sort_pad(cand, cap, self.domain)
        deduped, rec.deduped = _dedup_sorted(cand, self.domain)

        delta_rows, delta_count, strategy = set_difference(
            deduped,
            rec.deduped,
            handle.rows,
            handle.count,
            self.domain,
            dsd_state[pred],
            mode=cfg.dsd if cfg.enable_oof or cfg.dsd != "dynamic" else "opsd",
        )
        rec.dsd_strategy = strategy
        rec.delta = delta_count

        store[pred] = handle.merge(delta_rows, delta_count)
        rec.full = store[pred].count
        dcap = next_bucket(max(delta_count, 1), cfg.capacity_min)
        deltas[pred] = TupleView(delta_rows[:dcap], delta_count, self.domain)
        return rec

    # -- DRed retraction: the over-delete / re-derive pass ---------------------

    def dred_stratum(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        store_old: dict[str, Any],
        deleted: dict[str, "TupleView"],
        changed: dict[str, "TupleView"],
        handles: dict[str, str],
        loop_groups: dict[str, list[RuleVariant]] | None = None,
    ) -> tuple[int, dict[str, "TupleView"], dict[str, "TupleView"]]:
        with _TRACE.span(
            "dred", "engine", stratum=stratum.index,
            seeds_deleted=len(deleted), seeds_changed=len(changed),
        ) as sp:
            iters, net_deleted, net_added = self._dred_stratum_impl(
                strat, stratum, store, store_old, deleted, changed,
                handles, loop_groups,
            )
            sp.set(
                iterations=iters,
                net_deleted=sum(v.count for v in net_deleted.values()),
                net_added=sum(v.count for v in net_added.values()),
            )
            return iters, net_deleted, net_added

    def _dred_stratum_impl(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        store_old: dict[str, Any],
        deleted: dict[str, "TupleView"],
        changed: dict[str, "TupleView"],
        handles: dict[str, str],
        loop_groups: dict[str, list[RuleVariant]] | None = None,
    ) -> tuple[int, dict[str, "TupleView"], dict[str, "TupleView"]]:
        """Delete-and-rederive for one tuple-backed stratum (DRed).

        ``deleted`` maps externally-shrunk relations (EDB or upstream IDBs) to
        their ∇ views; ``changed`` maps externally-grown ones to Δ views;
        ``store_old`` is the pre-update state of every relation (immutable
        handles — a shallow snapshot).  A write transaction's whole mixed
        Δ/∇ seed set is handled in this ONE visit.  Three passes:

        1. **Over-delete** — propagate ∇ through the stratum's rules with the
           non-∇ atoms read from ``store_old`` (a derivation is counted in the
           state it was made in), removing derived heads from the live store;
           the removed tuples are the next round's frontier, until empty.
        2. **Re-derive + ingest** — for every over-deleted tuple, a
           ∇-guarded variant of each rule re-checks derivability against the
           post-deletion state; together with ingest variants for upstream
           insertions these seed ΔR, and the resumable semi-naïve loop runs
           from iteration 1 to the new fixpoint.
        3. **Net diff** — old vs. new per predicate, returned as
           ``(iterations, net_deleted, net_added)`` views for downstream
           strata.  The result is bit-for-bit the from-scratch fixpoint.
        """
        cfg = self.config
        self._kinds = handles

        # -- pass 1: over-delete to a fixpoint of the deletion frontier ----
        nabla: dict[str, TupleRelation] = {}
        frontier: dict[str, TupleView] = dict(deleted)
        rounds = 0
        while frontier:
            rounds += 1
            with _TRACE.span(
                "overdelete", "engine", stratum=stratum.index, round=rounds,
                frontier={p: v.count for p, v in frontier.items()}
                if _TRACE.enabled else None,
            ):
                groups_del = deletion_variants(stratum, set(frontier))
                next_frontier: dict[str, TupleView] = {}
                for pred in stratum.preds:
                    bufs = []
                    for var in groups_del[pred]:
                        res = self._eval_variant(
                            strat, stratum, store_old, frontier, var
                        )
                        if res is not None:
                            bufs.append(res)
                    if not bufs:
                        continue
                    cand = torch.cat([b[0] for b in bufs], dim=0)
                    cand = _sort_pad(
                        cand, next_bucket(cand.shape[0], cfg.capacity_min), self.domain
                    )
                    cand, _ = _dedup_sorted(cand, self.domain)
                    new_h, removed, r_count = store[pred].delete_rows(cand)
                    if r_count == 0:
                        continue
                    store[pred] = new_h
                    dcap = next_bucket(r_count, cfg.capacity_min)
                    next_frontier[pred] = TupleView(
                        removed[:dcap], r_count, self.domain
                    )
                    acc = nabla.get(pred) or TupleRelation.empty(
                        pred, strat.pred_arity(pred), self.domain, self.device,
                        cfg.capacity_min,
                    )
                    nabla[pred] = acc.merge(removed, r_count)
                frontier = next_frontier

        # -- pass 2: ∇-guarded re-derivation + upstream-Δ ingest, then loop --
        deltas: dict[str, TupleView | None] = {p: None for p in stratum.preds}
        deltas.update(changed)
        dsd_state = {p: DSDState(alpha=cfg.alpha) for p in stratum.preds}
        for pred, acc in nabla.items():
            deltas[NABLA + pred] = TupleView(acc.rows, acc.count, self.domain)
        seed_groups = rederive_seed_variants(stratum, set(changed), nabla)
        for pred in stratum.preds:
            if not seed_groups[pred]:
                continue
            with _TRACE.span(
                "rule", "engine", pred=pred, stratum=stratum.index,
                phase="rederive", variants=len(seed_groups[pred]),
            ) as rule_span:
                rec = self._eval_idb_iteration(
                    strat, stratum, store, handles, deltas, dsd_state,
                    pred, seed_groups[pred], 0,
                )
                rule_span.set(candidates=rec.candidates, delta=rec.delta)
            self.stats.records.append(rec)
        if stratum.recursive:
            self._seminaive_loop(
                strat, stratum, store, handles, deltas, dsd_state,
                loop_groups or delta_variants(stratum), start_iteration=1,
            )

        # -- pass 3: net old-vs-new diff for downstream strata -------------
        net_deleted: dict[str, TupleView] = {}
        net_added: dict[str, TupleView] = {}
        for pred in stratum.preds:
            old_h, new_h = store_old[pred], store[pred]
            if new_h is old_h:
                continue     # zero-delta merges return the same handle
            acc = nabla.get(pred)
            if not changed and acc is not None:
                # Pure retraction: positive programs are monotone, so the new
                # fixpoint ⊆ the old one — nothing was net-added, and the net
                # deletions are exactly the ∇ tuples that re-derivation did
                # NOT restore.  Probe |∇| rows instead of the whole relation.
                rows, count, _ = set_difference(
                    acc.rows, acc.count, new_h.rows, new_h.count,
                    self.domain, DSDState(),
                )
                if count:
                    net_deleted[pred] = TupleView(
                        rows[: next_bucket(count, cfg.capacity_min)],
                        count,
                        self.domain,
                    )
                continue
            # Mixed upstream diff (deletions + insertions): the stratum can
            # both shrink and grow — fall back to full both-way diffs.
            for src, dst, out in (
                (old_h, new_h, net_deleted),
                (new_h, old_h, net_added),
            ):
                if src.count == 0:
                    continue
                rows, count, _ = set_difference(
                    src.rows, src.count, dst.rows, dst.count,
                    self.domain, DSDState(),
                )
                if count:
                    out[pred] = TupleView(
                        rows[: next_bucket(count, cfg.capacity_min)],
                        count,
                        self.domain,
                    )
        iters = rounds + (
            self.stats.iterations.get(stratum.index, 0) if stratum.recursive else 0
        )
        self.stats.iterations[stratum.index] = iters
        return iters, net_deleted, net_added

    # -- body evaluation ------------------------------------------------------

    def _view_for(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        deltas: dict[str, TupleView | None],
        atom: Atom,
        use_delta: bool,
    ) -> TupleView:
        cfg = self.config
        if use_delta:
            # An explicit Δ view wins for every handle kind (dense preds keep
            # ``deltas[pred] = None`` and fall through to their handle).
            view = deltas.get(atom.pred)
            if view is not None:
                return view
        handle = store.get(atom.pred)
        if handle is None:
            return _empty_view(atom.arity, self.domain, self.device)
        if isinstance(handle, TupleRelation):
            if use_delta:
                return _empty_view(atom.arity, self.domain, self.device)
            return TupleView(handle.rows, handle.count, self.domain)
        # dense handles: materialize a tuple view
        cap = next_bucket(
            max(handle.delta_count if use_delta else handle.count, 1),
            cfg.capacity_min,
        )
        if isinstance(handle, DenseSetRelation):
            if use_delta:
                rows, count = handle.delta_tuples(cap)
            else:
                rows, count = _key_column(handle.member, cap)[:, None], handle.count
            return TupleView(rows, count, self.domain)
        if isinstance(handle, DenseAggRelation):
            rows, count = (
                handle.delta_tuples(cap) if use_delta else handle.full_tuples(cap)
            )
            return TupleView(rows, count, self.domain)
        raise TypeError(type(handle))

    def _eval_variant(
        self,
        strat: Stratification,
        stratum: Stratum,
        store: dict[str, Any],
        deltas: dict[str, TupleView | None],
        variant: RuleVariant,
    ):
        cfg = self.config
        rule = variant.rule
        atoms = list(rule.atoms)

        views: dict[int, TupleView] = {}
        for i, atom in enumerate(atoms):
            if atom.negated:
                continue
            use_delta = variant.delta_idx == i
            views[i] = self._view_for(strat, stratum, store, deltas, atom, use_delta)
            if views[i].count == 0:
                return None   # empty input ⇒ empty body (positive atoms only)

        sizes = {i: v.count for i, v in views.items()}
        order = order_atoms(atoms, variant.delta_idx, sizes, oof=cfg.enable_oof)

        first = order[0]
        bindings = init_bindings(atoms[first], views[first].rows, views[first].count)
        pending_cmps = list(rule.comparisons)
        bindings, pending_cmps = self._apply_ready(bindings, pending_cmps)

        for i in order[1:]:
            atom, view = atoms[i], views[i]
            shared = [v for v in atom.vars() if v in bindings.cols]
            if shared:
                key_var = shared[0]
                col = next(
                    p
                    for p, t in enumerate(atom.terms)
                    if isinstance(t, Var) and t == key_var
                )
                build_rows, build_key = view.sorted_by(col)
                probe_key = bindings.cols[key_var]
                lo, counts = join_counts(bindings, probe_key, build_key)
            else:
                build_rows = view.rows
                lo = torch.zeros(bindings.valid.shape, dtype=torch.int32, device=self.device)
                counts = torch.where(bindings.valid, view.count, 0).to(torch.int32)
            total = int(counts.sum())
            if total == 0:
                return None
            cap = next_bucket(total, cfg.capacity_min)
            bindings = join_materialize(bindings, atom, build_rows, lo, counts, cap)
            bindings, pending_cmps = self._apply_ready(bindings, pending_cmps)

        for atom in atoms:
            if atom.negated:
                view = self._view_for(strat, stratum, store, deltas, atom, False)
                bindings = antijoin(bindings, atom, view.rows, self.domain)

        assert not pending_cmps, f"unapplied comparisons in {rule}"

        if rule.has_aggregate:
            if self._kinds.get(rule.head_pred) == "dense_agg":
                return bindings, bindings.valid, rule
            cap = next_bucket(bindings.capacity, cfg.capacity_min)
            rows, _count = groupby_aggregate(rule, bindings, cap)
            return rows, rows[:, 0] != SENTINEL, rule
        if self._kinds.get(rule.head_pred) == "dense_set":
            return bindings, bindings.valid, rule
        rows, valid = project_head(rule, bindings)
        return rows, valid, rule

    @staticmethod
    def _apply_ready(bindings: Bindings, cmps: list):
        remaining = []
        for c in cmps:
            if all(v in bindings.cols for v in c.vars()):
                bindings = apply_comparison(bindings, c)
            else:
                remaining.append(c)
        return bindings, remaining

    # -- EOST ablation ----------------------------------------------------------

    def _simulate_commit(self, stratum: Stratum, store: dict[str, Any]) -> None:
        """EOST-off: force a host round-trip (and optional disk write) per
        iteration — the 'dirty page writeback' the paper's EOST avoids."""
        blobs = {}
        for pred in stratum.preds:
            h = store.get(pred)
            if h is None:
                continue
            for fname in ("rows", "member", "values"):
                arr = getattr(h, fname, None)
                if arr is not None:
                    blobs[f"{pred}.{fname}"] = arr.cpu().numpy()
        if self.config.eost_spill_dir:
            os.makedirs(self.config.eost_spill_dir, exist_ok=True)
            np.savez(
                os.path.join(self.config.eost_spill_dir, f"commit_{stratum.index}.npz"),
                **blobs,
            )

    def _save_fixpoint(
        self,
        path: str,
        stratum_index: int,
        iteration: int,
        store: dict[str, Any],
        deltas: dict[str, "TupleView | None"] | None = None,
    ) -> None:
        """Mid-fixpoint checkpoint in the ``repro_torch.persist`` snapshot
        format (the reference's, byte for byte).

        The semi-naïve loop's live Δ views ride along as extra arrays —
        without them a resumed tuple stratum would see empty deltas and
        declare a premature fixpoint.  (Dense handles carry their own delta
        state and need nothing extra.)  Checkpoints are numbered by a
        per-engine sequence; ``resume_from`` loads the newest valid one, so
        a checkpoint torn by a crash falls back to its predecessor.
        """
        from repro_torch.persist.codec import (
            list_snapshots,
            prune_snapshots,
            snapshot_dir_epoch,
            write_snapshot,
        )

        if not hasattr(self, "_ckpt_seq"):
            # continue past any checkpoints already in the directory: a rerun
            # into a reused checkpoint_dir must number its snapshots AFTER
            # the stale run's, or newest-wins resume would load the old run's
            # state (and write_snapshot would no-op on an existing epoch)
            existing = list_snapshots(path)
            self._ckpt_seq = (
                snapshot_dir_epoch(existing[-1]) if existing else 0
            )
        self._ckpt_seq += 1
        extra_meta: dict[str, Any] = {
            "engine_checkpoint": True,
            "stratum": stratum_index,
            "iteration": iteration,
            "delta_counts": {},
        }
        extra_arrays: dict[str, torch.Tensor] = {}
        for pred, view in (deltas or {}).items():
            if view is None or getattr(view, "count", 0) == 0:
                continue
            extra_meta["delta_counts"][pred] = int(view.count)
            extra_arrays[f"delta.{pred}"] = view.rows
        if self.device.type == "cuda":
            # the iteration's kernels are done before anything is copied
            torch.cuda.synchronize(self.device)
        write_snapshot(
            path,
            handles=store,
            domain=self.domain,
            epoch=self._ckpt_seq,
            extra_meta=extra_meta,
            extra_arrays=extra_arrays,
        )
        prune_snapshots(path, keep=2)

    def _load_fixpoint(self, path: str, strat: Stratification, store: dict[str, Any]):
        """Load the newest valid checkpoint written by :meth:`_save_fixpoint`
        (or by the reference's) onto the engine's device.

        Restores every relation handle, re-seeds the saved Δ views (consumed
        by ``_eval_stratum`` when it resumes mid-stratum), and returns
        ``(stratum_index, iteration, store)``.
        """
        from repro_torch.persist.codec import SnapshotError, latest_valid_snapshot

        snap = latest_valid_snapshot(path, device=self.device)
        if snap is None:
            raise SnapshotError(f"no valid fixpoint checkpoint under {path!r}")
        self.domain = snap.domain
        store.update(snap.handles)
        self._resume_deltas = {}
        for pred, count in snap.extra_meta.get("delta_counts", {}).items():
            rows = snap.extra_arrays.get(f"delta.{pred}")
            if rows is not None:
                self._resume_deltas[pred] = TupleView(rows, int(count), self.domain)
        return (
            int(snap.extra_meta.get("stratum", 0)),
            int(snap.extra_meta.get("iteration", 0)),
            store,
        )
