"""The per-layer readers of the program's spans, each on a span list made by
hand, on an empty one, and on the records of an untraced run."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench.harness.spec import load_cell, metric_reader

_ids = iter(range(1, 1 << 30))


def span(name, dur_ms=0.0, device_ms=None, syncs=0, parent=None, **args):
    return SimpleNamespace(
        name=name, dur_ns=round(dur_ms * 1e6), syncs=syncs, args=args,
        device_ns=None if device_ms is None else round(device_ms * 1e6),
        span_id=next(_ids), parent_id=parent.span_id if parent else 0)


def evaluation(spans_of_one):
    """One evaluation's spans under its ``bench.evaluation``."""
    top = span("bench.evaluation", 10.0)
    out = [top]
    for s in spans_of_one:
        s.parent_id = top.span_id
        out.append(s)
    return out


EVAL_SPANS = (
    evaluation([span("engine.prep", 2.0, syncs=3), span("edb.upload", 1.0, 0.25),
                span("engine.run", 6.0, syncs=7), span("pbme.fixpoint", 4.0, 3.0, products=7),
                span("pbme.transpose", 0.5, 0.3), span("pbme.mask", 0.4, 0.2),
                span("pbme.to_rows", 0.6, 0.5)])
    + evaluation([span("engine.prep", 1.0, syncs=3), span("edb.upload", 2.0, 0.25),
                  span("engine.run", 5.0, syncs=9), span("pbme.fixpoint", 4.0, 3.0, products=9),
                  span("pbme.transpose", 0.5, 0.3), span("pbme.mask", 0.4, 0.2),
                  span("pbme.to_rows", 0.6, 0.7)])
)


def _serve_spans():
    delete = span("txn.apply", 20.0)
    stratum = span("stratum", 18.0, parent=delete)
    insert = span("txn.apply", 15.0)
    # a transaction with two strata recomputed counts once
    two = span("txn.apply", 30.0)
    return [
        delete, stratum, span("recompute.diff", 1.0, 0.4, parent=stratum),
        insert, span("stratum", 14.0, parent=insert),
        two, span("recompute.diff", 2.0, 0.4, parent=two),
        span("recompute.diff", 3.0, 0.4, parent=two),
        span("query.lookup", 0.5, 0.25), span("query.lookup", 0.5, 0.75),
        span("query.wait", 0.2),
    ]


#: metric → (kind, spans, value)
BY_HAND = {
    "upload_ms.eval": ("eval", EVAL_SPANS, 1.5),
    "to_rows_ms.eval": ("eval", EVAL_SPANS, 0.6),
    "host_syncs.eval": ("eval", EVAL_SPANS, 11.0),
    "products.eval": ("eval", EVAL_SPANS, 8.0),
    "sg_prologue_ms.eval": ("eval", EVAL_SPANS, 0.5),
    "diff_ms.serve": ("serve", _serve_spans(), 3.0),
    "lookup_ms.serve": ("serve", _serve_spans(), 0.5),
}


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_a_reader_on_spans_made_by_hand(name):
    kind, spans, want = BY_HAND[name]
    assert metric_reader(name)({"kind": kind, "spans": spans}) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_a_reader_finds_nothing_without_its_spans(name):
    kind, spans, _ = BY_HAND[name]
    read = metric_reader(name)
    assert read({"kind": kind, "spans": []}) is None
    assert read({"kind": kind}) is None
    other = "serve" if kind == "eval" else "eval"
    assert read({"kind": other, "spans": spans}) is None


@pytest.mark.parametrize("name", ["to_rows_ms.eval", "sg_prologue_ms.eval", "lookup_ms.serve"])
def test_a_device_time_reader_finds_nothing_off_the_card(name):
    """On the CPU a device span has no device time: nothing to read."""
    kind, spans, _ = BY_HAND[name]
    cpu = [SimpleNamespace(**dict(vars(s), device_ns=None)) for s in spans]
    assert metric_reader(name)({"kind": kind, "spans": cpu}) is None


def test_each_span_reader_names_its_cells():
    """The span readers of the eval cells, and SG's prologue in its cell
    alone; the serve cell's two."""
    tc, sg, serve = (load_cell(c) for c in ("tc-g10k.eval", "sg-g10k.eval", "tc-g10k.serve"))
    evals = {"upload_ms.eval", "to_rows_ms.eval", "host_syncs.eval", "products.eval"}
    names = {c.name: {m["name"] for m in c.per_layer} for c in (tc, sg, serve)}
    assert evals <= names["tc-g10k.eval"] and "sg_prologue_ms.eval" not in names["tc-g10k.eval"]
    assert evals | {"sg_prologue_ms.eval"} <= names["sg-g10k.eval"]
    assert {"diff_ms.serve", "lookup_ms.serve"} <= names["tc-g10k.serve"]
    assert not evals & names["tc-g10k.serve"]
