"""What the per-layer readers take from a traced run's ``records["spans"]``:
the spans of ``repro_torch.obs.trace`` recorded over the window, each with
``name``, ``dur_ns`` (host ns, -1 for an instant), ``device_ns`` (the CUDA
events' ns on the card, else ``None``), ``syncs``, ``args``, ``span_id`` and
``parent_id``.  An untraced run's list is empty, and so is every answer."""

from __future__ import annotations

from typing import Callable


def named(records: dict, kind: str, *names: str) -> list:
    """The finished spans called one of ``names`` in a run of ``kind``."""
    if records.get("kind") != kind:
        return []
    return [s for s in records.get("spans", ()) if s.name in names and s.dur_ns >= 0]


def per_evaluation(records: dict, value: Callable, *names: str) -> float | None:
    """The sum of ``value(span)`` over the spans of ``names``, over the
    window's evaluations (its ``bench.evaluation`` spans); ``None`` where
    no span gives a value."""
    evaluations = len(named(records, "eval", "bench.evaluation"))
    values = [v for v in map(value, named(records, "eval", *names)) if v is not None]
    if not evaluations or not values:
        return None
    return sum(values) / evaluations


def device_ms(span) -> float | None:
    return None if span.device_ns is None else span.device_ns / 1e6


def host_ms(span) -> float:
    return span.dur_ns / 1e6


def by_id(records: dict) -> dict:
    """Every span of the run by its ``span_id``."""
    return {s.span_id: s for s in records.get("spans", ())}


def enclosing(span, spans_by_id: dict, name: str):
    """The innermost span called ``name`` that ``span`` was opened inside
    (on its thread), or ``None``."""
    parent = spans_by_id.get(span.parent_id)
    while parent is not None and parent.name != name:
        parent = spans_by_id.get(parent.parent_id)
    return parent
