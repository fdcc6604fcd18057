"""The ``andersen-d5.eval`` cell: Andersen's points-to analysis on RecStep's
dataset 5, judged on ``pointsTo`` by ``reference/points_to.py``.  The cell is
found by name with its metrics; the frozen generator is held to the port's;
the reference is held to a case worked by hand and to the repository's own
plain reference; the same configuration at dataset 2 runs through the
harness on the CPU, correct with every check 0, while planted faults and the
control come out not correct; and each new reader is read on spans made by
hand."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import time

import numpy as np
import pytest
import torch

from bench.harness import cell, evalcell
from bench.harness.spec import ROOT, generator, load_cell, metric_reader, reference
from bench.tests.test_bench_spans import evaluation, span
from bench.tests.tiny import tiny_root

CELL = "andersen-d5.eval"
SPEC = {"kind": "points_to"}
SEED = 2**31 + 71

NEW_READERS = {"dedup_ms.eval", "setdiff_ms.eval", "derivations.eval"}


def plain_points_to():
    """The repository's own plain reference, ``tests/plain_points_to.py``,
    with its case worked by hand (``BY_HAND_*``)."""
    spec = importlib.util.spec_from_file_location(
        "plain_points_to", ROOT / "tests" / "plain_points_to.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_cell_is_found_by_name():
    c = load_cell(CELL)
    assert c.chips == 1 and c.traffic["kind"] == "eval"
    assert c.config["name"] == "andersen-d5" and c.config["reduced"] == ["scale"]
    assert c.config["idb"] == "pointsTo" and c.config["reference"] == SPEC
    assert c.config["edb"] == {"generator": "andersen_facts", "args": {"scale": 5, "seed": 0}}
    assert c.config["nodes"] == 1405 and c.config["engine"] == {}
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "eval_s", "peak_dev_gib"}
    assert {m["name"] for m in c.per_layer} == {
        "prep_ms.eval", "device_idle_pct.eval", "upload_ms.eval", "host_syncs.eval",
    } | NEW_READERS
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW_READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "eval_s"
            assert m["layer"] == "engine loop"


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 5])
def test_the_generator_is_the_ports(scale):
    from repro_torch.data.program_facts import andersen_facts

    want, n = andersen_facts(scale)
    got = generator("andersen_facts")(scale=scale, seed=0)
    assert set(got) == set(want) == {"addressOf", "assign", "load", "store"}
    for rel in want:
        assert got[rel].dtype == np.int32 and np.array_equal(got[rel], want[rel]), rel
    if scale == 5:
        assert n == load_cell(CELL).config["nodes"]
        assert {k: len(v) for k, v in got.items()} == {
            "addressOf": 1123, "assign": 2105, "load": 562, "store": 562}


def test_points_to_by_hand():
    plain = plain_points_to()
    edb = {k: np.array(v, np.int32) for k, v in plain.BY_HAND_EDB.items()}
    facts = plain.BY_HAND_FACTS
    ref = reference("points_to").fixpoint(edb, SPEC, 5, "cpu")
    assert ref.keys.tolist() == list(range(5)) and ref.keys.dtype == torch.int64
    assert [tuple(p) for p in torch.nonzero(ref.bits).tolist()] == facts
    assert ref.rounds == plain.BY_HAND_ROUNDS and ref.count == len(facts)
    assert ref.row(4).tolist() == [1, 2] and ref.row(7).tolist() == []
    short = reference("points_to").fixpoint(edb, SPEC, 5, "cpu", max_rounds=1)
    assert short.rounds == 1 and short.count == len(facts) - 1
    assert not bool(short.bits[4, 1])


@pytest.mark.parametrize("seed", [1, SEED])
@pytest.mark.parametrize("scale", [1, 2])
def test_points_to_agrees_with_the_plain_reference(scale, seed):
    from bench.harness import inputs

    config = dict(load_cell(CELL).config, nodes=int(60 * 2.2 ** (scale - 1)))
    config["edb"] = {"generator": "andersen_facts", "args": {"scale": scale}}
    data = inputs.make(config, {"kind": "eval"}, seed)
    plain = plain_points_to()
    ref = reference("points_to").fixpoint(data.edb, SPEC, data.n, "cpu")
    pairs, rounds = plain.points_to(data.edb, data.n)
    assert ref.rounds == rounds >= 5
    assert torch.equal(torch.nonzero(ref.bits).to(torch.int32), torch.as_tensor(pairs))
    for k in range(rounds):
        short = reference("points_to").fixpoint(data.edb, SPEC, data.n, "cpu", max_rounds=k)
        pairs_k, rounds_k = plain.points_to(data.edb, data.n, max_rounds=k)
        assert short.rounds == rounds_k == k
        assert torch.equal(torch.nonzero(short.bits).to(torch.int32), torch.as_tensor(pairs_k))


# -- the configuration at dataset 2, through the harness on the CPU --------------------

TINY = "andersen-tiny.eval"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny root with ``andersen-d5.json`` at dataset 2 as ``andersen-tiny``,
    and its cell reporting what ``andersen-d5.eval`` reports."""
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    cfg = json.loads((ROOT / "bench" / "configs" / "andersen-d5.json").read_text())
    cfg["edb"]["args"]["scale"] = 2
    cfg["nodes"] = 132
    (root / "bench" / "configs" / "andersen-tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "andersen-tiny", "source": "tiny",
                             "file": "bench/configs/andersen-tiny.json", "reduced": ["scale"],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": TINY, "config": "andersen-tiny", "traffic": "eval",
                               "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, trace=False, program=None, seed=SEED):
    return cell.run(TINY, seed, 0.3, trace, t_start=time.perf_counter(), root=root,
                    device="cpu", program=program)


def _tiny_data(root, seed=SEED):
    from bench.harness import inputs

    c = load_cell(TINY, root)
    return inputs.make(c.config, c.traffic, seed, root)


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_is_correct(root, trace):
    r = _run(root, trace)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"missing_facts", "extra_facts", "duplicate_rows",
                                "count_off_max", "iterations_off_max", "failed_evaluations"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    if not trace:
        assert set(r["metrics"]) == {"setup_s", "eval_s", "peak_dev_gib"}
        return
    # off the card no span has device time: the device readers fall silent
    assert set(r["metrics"]) == {"prep_ms.eval", "upload_ms.eval", "host_syncs.eval",
                                 "derivations.eval"}
    data = _tiny_data(root)
    assert r["metrics"]["derivations.eval"]["value"] == sum(
        plain_points_to().derivations(data.edb, data.n))


def _short_rows(root):
    data = _tiny_data(root)
    ref = reference("points_to", root)
    full = ref.fixpoint(data.edb, SPEC, data.n, "cpu")
    short = ref.fixpoint(data.edb, SPEC, data.n, "cpu", max_rounds=full.rounds - 1)
    return torch.nonzero(short.bits).to(torch.int32)


class _Faulty:
    """The engine's program with one fault planted in what it produced."""

    def __init__(self, root, fault):
        self.inner = evalcell.EngineProgram(load_cell(TINY, root).config, "cpu")
        self.root, self.fault = root, fault

    def __call__(self, text, edb):
        return self.fault(self.inner(text, edb), self.root)


def _rows(ev, rows):
    return dataclasses.replace(ev, rows=rows, count=len(rows))


def fact_missing(ev, root):
    rows = ev.judged_rows()
    return _rows(ev, torch.cat([rows[:5], rows[6:]]))


def extra_fact(ev, root):
    rows = ev.judged_rows()
    n = load_cell(TINY, root).config["nodes"]
    held = set(map(tuple, rows.tolist()))
    extra = next((x, y) for x in range(n) for y in range(n) if (x, y) not in held)
    return _rows(ev, torch.cat([rows, torch.tensor([extra], dtype=torch.int32)]))


def repeated_row(ev, root):
    rows = ev.judged_rows()
    return _rows(ev, torch.cat([rows, rows[7:8]]))


def round_short(ev, root):
    return _rows(ev, _short_rows(root))


def iterations_off_by_one(ev, root):
    return dataclasses.replace(ev, iterations=ev.iterations - 1)


#: fault → the check it must move
FAULTS = {fact_missing: "missing_facts", extra_fact: "extra_facts",
          repeated_row: "duplicate_rows", round_short: "missing_facts",
          iterations_off_by_one: "iterations_off_max"}


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(root, fault):
    r = _run(root, program=_Faulty(root, fault))
    assert r["correct"] is False
    assert r["checks"][FAULTS[fault]]["value"] > 0, r["checks"]


def test_the_control_is_not_correct(root):
    from bench.control import control_run

    r = control_run(TINY, SEED + 1, 0.3, "cpu", root=root)
    assert r["correct"] is False
    assert r["checks"]["missing_facts"]["value"] > 0
    assert r["checks"]["extra_facts"]["value"] == 0
    assert r["checks"]["iterations_off_max"]["value"] == 1


# -- the new readers, on spans made by hand ------------------------------------------

def _round(iteration, candidates, dedup_ms, dsd_ms, merge_ms, delta=1):
    return [span("uie.dedup", 2 * dedup_ms, dedup_ms, pred="pointsTo", iteration=iteration,
                 candidates=candidates, deduped=candidates // 2, capacity=1 << 10),
            span("dsd", 2 * dsd_ms, dsd_ms, delta=delta),
            span("idb.merge", 2 * merge_ms, merge_ms)]


ANDERSEN_SPANS = (
    evaluation(_round(0, 300, 1.0, 0.5, 0.25) + [span("join", 0.5, 0.25, rows_in=10, rows=40)]
               + _round(1, 700, 2.0, 0.25, 0.5)
               + [span("membership", 0.2, 0.1, path="key", rows=140)])
    + evaluation(_round(0, 300, 3.0, 0.75, 0.25) + _round(1, 700, 2.0, 0.5, 0.5, delta=0))
)

#: reader → its value on ANDERSEN_SPANS
BY_HAND_READS = {
    "dedup_ms.eval": (1.0 + 2.0 + 3.0 + 2.0) / 2,
    "setdiff_ms.eval": (0.5 + 0.25 + 0.25 + 0.5 + 0.75 + 0.25 + 0.5 + 0.5) / 2,
    "derivations.eval": (300 + 700 + 300 + 700) / 2,
}


@pytest.mark.parametrize("name", sorted(NEW_READERS))
def test_a_new_reader_on_spans_by_hand(name):
    read = metric_reader(name)
    assert read({"kind": "eval", "spans": ANDERSEN_SPANS}) == pytest.approx(BY_HAND_READS[name])
    assert read({"kind": "eval", "spans": []}) is None
    assert read({"kind": "eval", "evaluations": []}) is None
    assert read({"kind": "serve", "spans": ANDERSEN_SPANS}) is None
    # a tuple-path run without the spans, as a program that lacks them gives
    without = [s for s in ANDERSEN_SPANS if s.name not in ("uie.dedup", "dsd", "idb.merge")]
    assert read({"kind": "eval", "spans": without}) is None


@pytest.mark.parametrize("name", sorted(NEW_READERS - {"derivations.eval"}))
def test_a_device_reader_is_silent_off_the_card(name):
    """Spans with no device time (a CPU run) give no number."""
    cpu = []
    for s in ANDERSEN_SPANS:
        t = span(s.name, s.dur_ns / 1e6, None, **s.args)
        t.span_id, t.parent_id = s.span_id, s.parent_id
        cpu.append(t)
    assert metric_reader(name)({"kind": "eval", "spans": cpu}) is None
