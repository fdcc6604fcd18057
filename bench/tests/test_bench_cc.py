"""The ``cc-rmat1m.eval`` cell: connected components (CC) on RecStep's RMAT-1M,
judged on ``cc2``'s labels by ``reference/min_label.py``.  The cell is found
by name with its metrics; the reference is held to a graph worked by hand and
to the repository's own plain reference; the same configuration at
``n_log2 = 10`` runs through the harness on the CPU, correct with every check
0, while planted faults and the control come out not correct; and each new
reader is read on spans made by hand."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import time

import numpy as np
import pytest
import torch

from bench.harness import cell, evalcell
from bench.harness.peaks import HBM_BYTES_PER_S
from bench.harness.spec import ROOT, load_cell, metric_reader, reference
from bench.tests.test_bench_spans import evaluation, span
from bench.tests.tiny import tiny_root

CELL = "cc-rmat1m.eval"
SPEC = {"kind": "min_label", "edge": "arc"}
SEED = 2**31 + 53

#: 8 nodes: 5 → 3 → 4 → 6 → 3 is a cycle fed by 5, and 7 → 2 → 1; node 0 has
#: no arc.  Round 1 lowers 4 to 3, 6 to 4 and gives 1 the label 2; round 2
#: lowers 6 to 3; round 3 lowers nothing.
BY_HAND_ARC = [(5, 3), (3, 4), (4, 6), (6, 3), (7, 2), (2, 1)]
BY_HAND_LABELS = [(1, 2), (2, 2), (3, 3), (4, 3), (5, 5), (6, 3), (7, 7)]
BY_HAND_ROUNDS = 2
#: the base reads the 6 arcs; round 1 the out-edges of every source, round 2
#: those of 4, 6 and 1, round 3 (the empty one) those of 6
BY_HAND_CANDIDATES = [6, 6, 2, 1]

NEW_READERS = {"propagate_ms.eval", "join_ms.eval", "membership_ms.eval", "candidates.eval",
               "propagate_roofline"}


def plain_min_label():
    """The repository's own plain reference, ``tests/plain_min_label.py``."""
    spec = importlib.util.spec_from_file_location(
        "plain_min_label", ROOT / "tests" / "plain_min_label.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.min_label


def test_the_cell_is_found_by_name():
    c = load_cell(CELL)
    assert c.chips == 1 and c.traffic["kind"] == "eval"
    assert c.config["name"] == "cc-rmat1m" and c.config["reduced"] == ["n_log2"]
    assert c.config["idb"] == "cc2" and c.config["reference"] == SPEC
    assert c.config["edb"] == {"generator": "rmat_graph",
                               "args": {"n_log2": 20, "edge_factor": 10, "seed": 0}}
    assert c.config["nodes"] == 1 << 20 and c.config["engine"] == {}
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "eval_s", "peak_dev_gib"}
    assert {m["name"] for m in c.per_layer} == {
        "prep_ms.eval", "device_idle_pct.eval", "upload_ms.eval", "host_syncs.eval"
    } | NEW_READERS
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW_READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "eval_s"
            assert m["layer"] == "engine loop"


def test_min_label_by_hand():
    edb = {"arc": np.array(BY_HAND_ARC, np.int32)}
    ref = reference("min_label").fixpoint(edb, SPEC, 8, "cpu")
    assert list(zip(ref.keys.tolist(), ref.values.tolist())) == BY_HAND_LABELS
    assert ref.rounds == BY_HAND_ROUNDS and ref.count == len(BY_HAND_LABELS)
    assert ref.expected_iterations("tuple") == BY_HAND_ROUNDS + 4
    assert ref.keys.dtype == ref.values.dtype == torch.int64
    short = reference("min_label").fixpoint(edb, SPEC, 8, "cpu", max_rounds=1)
    assert short.rounds == 1 and dict(zip(short.keys.tolist(), short.values.tolist()))[6] == 4
    rows, rounds, candidates = plain_min_label()(np.array(BY_HAND_ARC), 8)
    assert rows.tolist() == [list(p) for p in BY_HAND_LABELS]
    assert (rounds, candidates) == (BY_HAND_ROUNDS, BY_HAND_CANDIDATES)


@pytest.mark.parametrize("seed", [1, SEED])
@pytest.mark.parametrize("n_log2", [8, 11])
def test_min_label_agrees_with_the_plain_reference(n_log2, seed):
    from bench.harness import inputs

    config = dict(load_cell(CELL).config, nodes=1 << n_log2)
    config["edb"] = {"generator": "rmat_graph", "args": {"n_log2": n_log2}}
    data = inputs.make(config, {"kind": "eval"}, seed)
    ref = reference("min_label").fixpoint(data.edb, SPEC, data.n, "cpu")
    rows, rounds, _ = plain_min_label()(data.edb["arc"], data.n)
    assert ref.rounds == rounds >= 3
    assert torch.equal(torch.stack([ref.keys, ref.values], 1), torch.as_tensor(rows).long())
    for k in range(rounds):
        short = reference("min_label").fixpoint(data.edb, SPEC, data.n, "cpu", max_rounds=k)
        rows_k, rounds_k, _ = plain_min_label()(data.edb["arc"], data.n, max_rounds=k)
        assert short.rounds == rounds_k == k
        assert torch.equal(short.values, torch.as_tensor(rows_k[:, 1]).long())


# -- the configuration at n_log2 = 10, through the harness on the CPU -------------------

TINY = "cc-tiny.eval"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny root with ``cc-rmat1m.json`` at ``n_log2 = 10`` as ``cc-tiny``,
    and its cell reporting what ``cc-rmat1m.eval`` reports."""
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    cfg = json.loads((ROOT / "bench" / "configs" / "cc-rmat1m.json").read_text())
    cfg["edb"]["args"]["n_log2"] = 10
    cfg["nodes"] = 1 << 10
    (root / "bench" / "configs" / "cc-tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cc-tiny", "source": "tiny",
                             "file": "bench/configs/cc-tiny.json", "reduced": ["n_log2"],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": TINY, "config": "cc-tiny", "traffic": "eval",
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
                                 "candidates.eval"}
    data = _tiny_data(root)
    _rows, _rounds, candidates = plain_min_label()(data.edb["arc"], data.n)
    assert r["metrics"]["candidates.eval"]["value"] == sum(candidates)


def _short_rows(root):
    data = _tiny_data(root)
    ref = reference("min_label", root)
    full = ref.fixpoint(data.edb, SPEC, data.n, "cpu")
    short = ref.fixpoint(data.edb, SPEC, data.n, "cpu", max_rounds=full.rounds - 1)
    return torch.stack([short.keys, short.values], 1).to(torch.int32)


class _Faulty:
    """The engine's program with one fault planted in what it produced."""

    def __init__(self, root, fault):
        self.inner = evalcell.EngineProgram(load_cell(TINY, root).config, "cpu")
        self.root, self.fault = root, fault

    def __call__(self, text, edb):
        return self.fault(self.inner(text, edb), self.root)


def _rows(ev, rows):
    return dataclasses.replace(ev, rows=rows, handle=None, count=len(rows))


def label_off_by_one(ev, root):
    rows = ev.judged_rows().clone()
    rows[len(rows) // 2, 1] += 1
    return _rows(ev, rows)


def node_missing(ev, root):
    rows = ev.judged_rows()
    return _rows(ev, torch.cat([rows[:5], rows[6:]]))


def round_short(ev, root):
    return _rows(ev, _short_rows(root))


def iterations_off_by_one(ev, root):
    return dataclasses.replace(ev, iterations=ev.iterations + 1)


#: fault → the check it must move
FAULTS = {label_off_by_one: "missing_facts", node_missing: "missing_facts",
          round_short: "missing_facts", iterations_off_by_one: "iterations_off_max"}


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
    assert r["checks"]["iterations_off_max"]["value"] == 1


# -- the new readers, on spans made by hand ------------------------------------------

def _round(iteration, candidates, domain, device_ms, improved=1):
    return span("agg.propagate", 2 * device_ms, device_ms, pred="cc3", iteration=iteration,
                candidates=candidates, improved=improved, domain=domain)


CC_SPANS = (
    evaluation([_round(0, 100, 1000, 1.0), span("join", 0.5, 0.25, rows_in=10, rows=40),
                _round(1, 40, 1000, 2.0), span("agg.groupby", 1.0, 0.5, rows_in=128, groups=9),
                span("membership", 0.2, 0.1, path="scan", rows=140),
                span("membership", 0.2, 0.3, path="key", rows=20)])
    + evaluation([_round(0, 100, 1000, 3.0), span("join", 0.5, 0.75, rows_in=10, rows=40),
                  _round(1, 40, 1000, 2.0, improved=0),
                  span("membership", 0.2, 0.2, path="scan", rows=140)])
)

#: reader → its value on CC_SPANS
BY_HAND_READS = {
    "propagate_ms.eval": (1.0 + 2.0 + 3.0 + 2.0) / 2,
    "join_ms.eval": (0.25 + 0.75) / 2,
    "membership_ms.eval": (0.1 + 0.3 + 0.2) / 2,
    "candidates.eval": (100 + 40 + 100 + 40) / 2,
    "propagate_roofline": 100.0 * (2 * (8 * 100 + 8 * 1000) + 2 * (8 * 40 + 8 * 1000))
    / HBM_BYTES_PER_S / 8e-3,
}


@pytest.mark.parametrize("name", sorted(NEW_READERS))
def test_a_new_reader_on_spans_by_hand(name):
    read = metric_reader(name)
    assert read({"kind": "eval", "spans": CC_SPANS}) == pytest.approx(BY_HAND_READS[name])
    assert read({"kind": "eval", "spans": []}) is None
    assert read({"kind": "eval", "evaluations": []}) is None
    assert read({"kind": "serve", "spans": CC_SPANS}) is None


@pytest.mark.parametrize("name", sorted(NEW_READERS - {"candidates.eval"}))
def test_a_device_reader_is_silent_off_the_card(name):
    """Spans with no device time (a CPU run) give no number."""
    cpu = []
    for s in CC_SPANS:
        t = span(s.name, s.dur_ns / 1e6, None, **s.args)
        t.span_id, t.parent_id = s.span_id, s.parent_id
        cpu.append(t)
    assert metric_reader(name)({"kind": "eval", "spans": cpu}) is None


def test_propagate_bytes_by_hand():
    """One round of RMAT-1M's propagation: 10,173,110 arc rows selected, read
    as int32 pairs, and 2^20 int32 labels read and written once."""
    from bench.harness.spec import _load

    mod = _load(ROOT / "bench" / "metrics" / "propagate_roofline.py", "bench_metric_")
    assert mod.propagate_bytes(10_173_110, 1 << 20) == 81_384_880 + 8_388_608
    one = evaluation([_round(1, 10_173_110, 1 << 20, 1.0)])
    want = 100.0 * 89_773_488 / HBM_BYTES_PER_S / 1e-3
    assert metric_reader("propagate_roofline")({"kind": "eval", "spans": one}) == pytest.approx(
        want)
    assert 2.6 < want < 2.7
