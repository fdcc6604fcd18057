"""Aggregation (paper §3.3): stratified group-by + recursive MIN/MAX.

Non-recursive aggregation lowers to sort-by-group-key → segment reduce (the
SQL GROUP BY analogue).  Recursive aggregation (CC, SSSP) goes through
:class:`repro_torch.core.relation.DenseAggRelation` — see the engine.
"""

from __future__ import annotations

import torch

from repro_torch.core.ast import Agg, Const, Rule
from repro_torch.core.joins import Bindings
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.relational.sort import SENTINEL, lexsort_rows, unique_mask

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


def eval_expr(expr, bindings: Bindings) -> torch.Tensor:
    """Evaluate a linear expression (``d1+d2``, ``0``) over binding columns."""
    out = torch.full(bindings.valid.shape, expr.const, dtype=torch.int32,
                     device=bindings.valid.device)
    for v in expr.vars:
        out = out + bindings.cols[v]
    return torch.where(bindings.valid, out, SENTINEL)


def _segment(op: str, seg_ids: torch.Tensor, vals: torch.Tensor, num_seg: int, init: int):
    out = torch.full((num_seg,), init, dtype=torch.int32, device=vals.device)
    return out.scatter_reduce(0, seg_ids, vals.to(torch.int32), op, include_self=True)


def groupby_aggregate(
    rule: Rule, bindings: Bindings, capacity: int
) -> tuple[torch.Tensor, int]:
    """Evaluate an aggregate head over a joined body.

    Returns (rows, count) with one output row per distinct group key, columns
    in head-term order (group keys + aggregate values interleaved as written).
    Traced as an ``agg.groupby`` device span.
    """
    with _TRACE.device_span(
        "agg.groupby", "engine", device=bindings.valid.device, rows_in=bindings.capacity
    ) as sp:
        rows, groups = _groupby_aggregate(rule, bindings, capacity)
        sp.set(groups=groups)
    return rows, groups


def _groupby_aggregate(
    rule: Rule, bindings: Bindings, capacity: int
) -> tuple[torch.Tensor, int]:
    group_terms = [t for t in rule.head_terms if not isinstance(t, Agg)]
    agg_terms = [(i, t) for i, t in enumerate(rule.head_terms) if isinstance(t, Agg)]
    if not agg_terms:
        raise ValueError("groupby_aggregate on non-aggregate rule")

    valid = bindings.valid
    dev = valid.device
    n = valid.shape[0]
    if group_terms:
        gcols = []
        for t in group_terms:
            if isinstance(t, Const):
                gcols.append(torch.where(valid, t.value, SENTINEL).to(torch.int32))
            else:
                gcols.append(bindings.cols[t])
        gmat = torch.stack(gcols, dim=1)
    else:
        gmat = torch.where(valid, 0, SENTINEL).to(torch.int32)[:, None]
    gmat = torch.where(valid[:, None], gmat, SENTINEL)
    order = lexsort_rows(gmat)
    gsorted = gmat[order]
    firsts = unique_mask(gsorted)
    present = gsorted[:, 0] != SENTINEL
    seg_ids = torch.cumsum(firsts, 0) - 1
    seg_ids = torch.where(present, seg_ids, n - 1)
    num_seg = n

    out_cols: dict[int, torch.Tensor] = {}
    for head_pos, agg in agg_terms:
        vals = eval_expr(agg.arg, bindings)[order]
        vals = torch.where(present, vals, 0)
        ones = present.to(torch.int32)
        if agg.op == "MIN":
            ini = torch.where(present, vals, INT32_MAX)
            agg_vals = _segment("amin", seg_ids, ini, num_seg, INT32_MAX)
        elif agg.op == "MAX":
            ini = torch.where(present, vals, INT32_MIN)
            agg_vals = _segment("amax", seg_ids, ini, num_seg, INT32_MIN)
        elif agg.op == "SUM":
            agg_vals = _segment("sum", seg_ids, vals, num_seg, 0)
        elif agg.op == "COUNT":
            agg_vals = _segment("sum", seg_ids, ones, num_seg, 0)
        elif agg.op == "AVG":
            s = _segment("sum", seg_ids, vals, num_seg, 0)
            c = _segment("sum", seg_ids, ones, num_seg, 0)
            agg_vals = torch.div(s, torch.clamp(c, min=1), rounding_mode="floor")
        else:
            raise ValueError(agg.op)
        out_cols[head_pos] = agg_vals

    # one output row per first-occurrence group row
    rows = []
    g_iter = iter(range(gsorted.shape[1]))
    for pos, term in enumerate(rule.head_terms):
        col = out_cols[pos][seg_ids] if isinstance(term, Agg) else gsorted[:, next(g_iter)]
        rows.append(torch.where(firsts, col, SENTINEL))
    mat = torch.where(firsts[:, None], torch.stack(rows, dim=1), SENTINEL)
    # compact firsts to the front, clip/pad to capacity
    mat = mat[torch.argsort(~firsts, stable=True)]
    if mat.shape[0] >= capacity:
        mat = mat[:capacity]
    else:
        pad = torch.full((capacity - mat.shape[0], mat.shape[1]), SENTINEL,
                         dtype=torch.int32, device=dev)
        mat = torch.cat([mat, pad], dim=0)
    return mat, int(firsts.sum())
