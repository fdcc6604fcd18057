"""ANALYZE: assemble per-request profiles from tracer spans + engine stats.

Where :mod:`repro_torch.obs.explain` predicts, this module measures.  A profiled
request's whole lifecycle already exists as tracer spans (``writer.apply`` →
``txn.apply`` → ``stratum`` → ``iteration`` → ``rule`` → ``epoch.publish``,
or ``serve.queries`` → ``query``); :func:`build_profile` walks the span
forest rooted at the request's marker attribute (``profile_rid`` /
``profile_rids``) and folds it into a :class:`FixpointProfile` — per-stratum
and per-rule actual cardinalities, wall time, device-sync time — annotated
with the plan-time estimates so every level carries its misestimation
ratio.  The same ratios are exported as histograms by the server
(``datalog_misestimation_ratio{level=...}``); this is the estimate-vs-actual
feedback signal that adaptive evaluation consumes.

Span objects are duck-typed (anything with ``name``/``args``/``span_id``/
``parent_id``/``dur_ns``); the one device touchpoint
(:func:`device_memory_stats`) reads the CUDA caching allocator and returns
``{}`` for the CPU.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.obs.trace import PORT_ONLY_SPANS


#: Misestimation-ratio histogram buckets: a symmetric log ladder around 1.0
#: (perfect estimate).  < 1 = overestimate, > 1 = underestimate.
RATIO_BUCKETS = (
    0.01, 0.05, 0.1, 0.2, 0.5, 0.8, 1.25, 2.0, 5.0, 10.0, 20.0, 100.0,
)


def misestimation_ratio(actual: float, est: float) -> float:
    """actual/est with +1 smoothing so empty deltas don't divide by zero.

    1.0 = perfect; 10.0 = the estimator was 10× too low; 0.1 = 10× too high.
    """
    return (float(actual) + 1.0) / (float(est) + 1.0)


def device_memory_stats(device=None) -> dict:
    """Current and peak device memory of a CUDA device, if any.

    ``torch.cuda.memory_stats(device)`` (the caching allocator's counters,
    ``allocated_bytes.all.peak`` and so on) for a CUDA device, or the
    current one when ``device`` is None; ``{}`` for a CPU device or where
    CUDA is not available.
    """
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


@dataclass
class ProfileNode:
    """One span of the request's trace, with its children."""

    name: str
    seconds: float
    attrs: dict = field(default_factory=dict)
    children: list["ProfileNode"] = field(default_factory=list)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "seconds": self.seconds,
            "attrs": dict(self.attrs),
            "children": [c.to_json() for c in self.children],
        }


@dataclass
class RuleProfile:
    """Actuals for one rule-group evaluation (one pred, one iteration)."""

    pred: str
    iteration: int
    candidates: int = 0
    delta: int = 0            # genuinely-new tuples this evaluation derived
    full: int = 0             # stored relation size afterwards
    dsd: str = "-"
    seconds: float = 0.0

    def to_json(self) -> dict:
        return {
            "pred": self.pred,
            "iteration": self.iteration,
            "candidates": self.candidates,
            "delta": self.delta,
            "full": self.full,
            "dsd": self.dsd,
            "seconds": self.seconds,
        }


@dataclass
class StratumProfile:
    """Actuals for one visited stratum, against its plan-time estimate."""

    index: int
    mode: str = "?"
    iterations: int = 0
    seconds: float = 0.0
    actual_rows: int = 0      # the engine's reported Δ total (derived)
    est_rows: float | None = None
    rules: list[RuleProfile] = field(default_factory=list)

    @property
    def ratio(self) -> float | None:
        if self.est_rows is None:
            return None
        return misestimation_ratio(self.actual_rows, self.est_rows)

    def rule_delta_total(self) -> int:
        return sum(r.delta for r in self.rules)

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "mode": self.mode,
            "iterations": self.iterations,
            "seconds": self.seconds,
            "actual_rows": self.actual_rows,
            "est_rows": self.est_rows,
            "ratio": self.ratio,
            "rules": [r.to_json() for r in self.rules],
        }


@dataclass
class FixpointProfile:
    """The runtime-annotated tree ``srv.profile(rid)`` returns."""

    rid: int
    kind: str                       # "query" | "txn" | "insert" | "delete"
    relation: str
    queued_seconds: float = 0.0
    service_seconds: float = 0.0
    epoch: int = -1
    strata: list[StratumProfile] = field(default_factory=list)
    roots: list[ProfileNode] = field(default_factory=list)
    device_sync_seconds: float = 0.0
    device_memory: dict = field(default_factory=dict)
    rows: int | None = None         # query result cardinality
    est_rows: float | None = None   # query-level estimate
    derived: int | None = None      # engine Δ total, from UpdateStats
    slow: bool = False              # captured by the slow-query log

    @property
    def sojourn_seconds(self) -> float:
        return self.queued_seconds + self.service_seconds

    @property
    def ratio(self) -> float | None:
        """Request-level misestimation: query rows or total derived."""
        if self.est_rows is None:
            return None
        actual = self.rows if self.rows is not None else (self.derived or 0)
        return misestimation_ratio(actual, self.est_rows)

    def rule_delta_total(self) -> int:
        return sum(s.rule_delta_total() for s in self.strata)

    # -- renderers ---------------------------------------------------------

    def render_text(self) -> str:
        lines = [
            f"profile rid={self.rid} kind={self.kind} rel={self.relation}"
            f"{' SLOW' if self.slow else ''}",
            f"├─ queued {self.queued_seconds * 1e3:.3f}ms"
            f"  service {self.service_seconds * 1e3:.3f}ms"
            f"  sojourn {self.sojourn_seconds * 1e3:.3f}ms"
            + (f"  epoch={self.epoch}" if self.epoch >= 0 else ""),
        ]
        if self.rows is not None:
            est = (
                f" est≈{self.est_rows:.3g} ratio={self.ratio:.3g}"
                if self.est_rows is not None
                else ""
            )
            lines.append(f"├─ rows={self.rows}{est}")
        if self.derived is not None:
            lines.append(f"├─ derived={self.derived}")
        if self.device_sync_seconds:
            lines.append(
                f"├─ device.sync {self.device_sync_seconds * 1e3:.3f}ms"
            )
        for i, s in enumerate(self.strata):
            last_s = i == len(self.strata) - 1 and not self.roots
            ratio = (
                f" est≈{s.est_rows:.3g} ratio={s.ratio:.3g}"
                if s.est_rows is not None
                else ""
            )
            lines.append(
                f"{'└─' if last_s else '├─'} stratum {s.index} [{s.mode}] "
                f"iters={s.iterations} Δ={s.actual_rows}{ratio} "
                f"{s.seconds * 1e3:.3f}ms"
            )
            bar = "   " if last_s else "│  "
            for j, r in enumerate(s.rules):
                last_r = j == len(s.rules) - 1
                lines.append(
                    f"{bar}{'└─' if last_r else '├─'} {r.pred}@it{r.iteration} "
                    f"cand={r.candidates} Δ={r.delta} full={r.full} "
                    f"dsd={r.dsd}"
                )
        for k, root in enumerate(self.roots):
            lines.extend(
                _render_node(root, prefix="", last=k == len(self.roots) - 1)
            )
        return "\n".join(lines)

    def to_json(self) -> dict:
        doc = {
            "rid": self.rid,
            "kind": self.kind,
            "relation": self.relation,
            "queued_seconds": self.queued_seconds,
            "service_seconds": self.service_seconds,
            "sojourn_seconds": self.sojourn_seconds,
            "epoch": self.epoch,
            "rows": self.rows,
            "est_rows": self.est_rows,
            "ratio": self.ratio,
            "derived": self.derived,
            "slow": self.slow,
            "device_sync_seconds": self.device_sync_seconds,
            "device_memory": dict(self.device_memory),
            "strata": [s.to_json() for s in self.strata],
            "spans": [r.to_json() for r in self.roots],
        }
        json.dumps(doc)       # the contract: always JSON-serialisable
        return doc


def _render_node(node: ProfileNode, prefix: str, last: bool) -> list[str]:
    tick = "└─" if last else "├─"
    hot = {
        k: v
        for k, v in node.attrs.items()
        if k in ("index", "mode", "iterations", "derived", "pred", "delta",
                 "epoch", "batch", "rows", "kind")
    }
    attrs = " ".join(f"{k}={v}" for k, v in hot.items())
    lines = [
        f"{prefix}{tick} {node.name} {node.seconds * 1e3:.3f}ms"
        + (f" [{attrs}]" if attrs else "")
    ]
    child_prefix = prefix + ("   " if last else "│  ")
    for i, c in enumerate(node.children):
        lines.extend(_render_node(c, child_prefix, i == len(node.children) - 1))
    return lines


def _marked_for(span, rid: int) -> bool:
    args = getattr(span, "args", None) or {}
    if args.get("profile_rid") == rid:
        return True
    rids = args.get("profile_rids")
    return bool(rids) and rid in rids


def spans_for_rid(spans, rid: int) -> list:
    """The request's span subtree: marker spans plus all their descendants.

    Roots are spans carrying ``profile_rid == rid`` (queries) or ``rid in
    profile_rids`` (group-committed transactions).  Descent follows
    ``parent_id`` — spans parent within one thread, so a writer-thread
    transaction's whole evaluation nests under its ``writer.apply`` marker
    and never leaks into a concurrent request's tree.
    """
    keep = {s.span_id for s in spans if _marked_for(s, rid)}
    if not keep:
        return []
    grew = True
    while grew:                  # spans() is start-sorted; parents precede
        grew = False
        for s in spans:
            if s.span_id not in keep and s.parent_id in keep:
                keep.add(s.span_id)
                grew = True
    return [s for s in spans if s.span_id in keep]


def _tree_from(spans) -> list[ProfileNode]:
    """The span forest, without the port's own phase spans
    (:data:`~repro_torch.obs.trace.PORT_ONLY_SPANS`): their children hang
    from the nearest span kept, so the tree is the reference's."""
    parent = {s.span_id: s.parent_id for s in spans}
    dropped = {s.span_id for s in spans if s.name in PORT_ONLY_SPANS}
    nodes = {
        s.span_id: ProfileNode(
            name=s.name,
            seconds=max(s.dur_ns, 0) / 1e9,
            attrs={
                k: v for k, v in (s.args or {}).items()
                if not k.startswith("profile_rid")
            },
        )
        for s in spans if s.span_id not in dropped
    }
    roots: list[ProfileNode] = []
    for s in spans:              # start-sorted → children append in time order
        if s.span_id in dropped:
            continue
        up = s.parent_id
        while up in dropped:
            up = parent[up]
        if up in nodes:
            nodes[up].children.append(nodes[s.span_id])
        else:
            roots.append(nodes[s.span_id])
    return roots


def build_profile(
    spans,
    rid: int,
    kind: str = "?",
    relation: str = "?",
    queued: float = 0.0,
    service: float = 0.0,
    epoch: int = -1,
    est_by_stratum: dict[int, float] | None = None,
    est_rows: float | None = None,
    derived: int | None = None,
    device_memory: dict | None = None,
) -> FixpointProfile:
    """Fold one request's span subtree into a :class:`FixpointProfile`.

    ``spans`` is the tracer snapshot (``TRACER.spans()``); only the subtree
    marked with this ``rid`` is consumed.  ``est_by_stratum`` carries the
    plan-time (or :meth:`PlanEstimate.scaled_delta`) estimates to annotate
    strata with; ``est_rows`` the query-level selection estimate.
    """
    mine = spans_for_rid(spans, rid)
    prof = FixpointProfile(
        rid=rid,
        kind=kind,
        relation=relation,
        queued_seconds=queued,
        service_seconds=service,
        epoch=epoch,
        est_rows=est_rows,
        derived=derived,
        device_memory=dict(device_memory or {}),
    )
    est_by_stratum = est_by_stratum or {}
    by_stratum: dict[int, StratumProfile] = {}
    for s in mine:
        args = s.args or {}
        dur = max(s.dur_ns, 0) / 1e9
        if s.name == "stratum" or s.name == "stratum.eval":
            idx = int(args.get("index", args.get("stratum", -1)))
            sp = by_stratum.setdefault(idx, StratumProfile(index=idx))
            sp.mode = str(args.get("mode", args.get("backend", sp.mode)))
            sp.iterations = int(args.get("iterations", sp.iterations))
            sp.seconds += dur
            sp.actual_rows += int(args.get("derived", 0))
            if idx in est_by_stratum:
                sp.est_rows = est_by_stratum[idx]
        elif s.name == "rule":
            idx = int(args.get("stratum", -1))
            sp = by_stratum.setdefault(idx, StratumProfile(index=idx))
            sp.rules.append(
                RuleProfile(
                    pred=str(args.get("pred", "?")),
                    iteration=int(args.get("iteration", 0)),
                    candidates=int(args.get("candidates", 0)),
                    delta=int(args.get("delta", 0)),
                    full=int(args.get("full", 0)),
                    dsd=str(args.get("dsd", "-")),
                    seconds=dur,
                )
            )
        elif s.name == "device.sync":
            prof.device_sync_seconds += dur
        elif s.name == "query":
            if "rows" in args:
                prof.rows = int(args["rows"])
            if prof.est_rows is None and "est_rows" in args:
                prof.est_rows = float(args["est_rows"])
    prof.strata = [by_stratum[i] for i in sorted(by_stratum)]
    prof.roots = _tree_from(mine)
    return prof
