"""A deployment that is not a closure, added from new files alone: connected
components (CC) on an RMAT graph, judged by its labels (one value per key),
and REACH's dense set, judged by its members.  Each tiny cell runs through
the harness on the CPU, correct with every check 0; planted faults and the
control each come out not correct."""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from bench.harness import cell, check, evalcell
from bench.harness.spec import reference
from bench.tests.tiny import tiny_root

CC = ("cc3(x, MIN(x)) :- arc(x, _).\ncc3(y, MIN(z)) :- cc3(x, z), arc(x, y).\n"
      "cc2(x, MIN(y)) :- cc3(x, y).\ncc(x) :- cc2(_, x).\n")
REACH = "reach(y) :- id(y).\nreach(y) :- reach(x), arc(x,y).\n"

#: a plain reference for CC's labels, as a configuration would bring it
CC_REFERENCE = '''"""CC's labels: each node's least label is the least node with an out-edge
that reaches it, by reachability over the whole domain; the rounds are
those of the labels' propagation along the arcs until none falls."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NONE = np.iinfo(np.int64).max


@dataclass
class Labels:
    keys: torch.Tensor
    values: torch.Tensor
    rounds: int

    @property
    def count(self) -> int:
        return len(self.keys)

    def expected_iterations(self, backend: str) -> int:
        # cc3: the base, the rounds and the empty one; cc2 and cc: one each
        return self.rounds + 4


def fixpoint(edb, spec, n, device, max_rounds=None):
    arc = np.asarray(edb[spec["edge"]], np.int64)
    src = np.unique(arc[:, 0])
    label = np.full(n, NONE)
    label[src] = src
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = label.copy()
        np.minimum.at(new, arc[:, 1], label[arc[:, 0]])
        if (new == label).all():
            break
        label, rounds = new, rounds + 1
    if max_rounds is None:
        reach = np.eye(n, dtype=bool)
        reach[arc[:, 0], arc[:, 1]] = True
        for k in range(n):
            reach |= reach[:, k:k + 1] & reach[k:k + 1, :]
        hit = reach[src]
        label = np.where(hit.any(axis=0), src[np.argmax(hit, axis=0)], NONE)
    keys = np.flatnonzero(label < NONE)
    return Labels(torch.as_tensor(keys, device=device),
                  torch.as_tensor(label[keys], device=device), rounds)
'''

#: a plain reference for REACH's members, keys alone
REACH_REFERENCE = '''"""REACH: the nodes reachable from ``id`` along the arcs, breadth first."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Members:
    keys: torch.Tensor
    rounds: int
    values = None

    @property
    def count(self) -> int:
        return len(self.keys)

    def expected_iterations(self, backend: str) -> int:
        return self.rounds + 2


def fixpoint(edb, spec, n, device, max_rounds=None):
    arc = np.asarray(edb[spec["edge"]], np.int64)
    member = np.zeros(n, bool)
    member[np.asarray(edb[spec["start"]])[:, 0]] = True
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = member.copy()
        new[arc[member[arc[:, 0]], 1]] = True
        if (new == member).all():
            break
        member, rounds = new, rounds + 1
    return Members(torch.as_tensor(np.flatnonzero(member), device=device), rounds)
'''

#: a generator a configuration brings as a file of its own
REACH_GENERATOR = '''import numpy as np


def tiny_reach(n, m, seed=0):
    rng = np.random.default_rng(seed)
    arc = np.unique(rng.integers(0, n, size=(m, 2)), axis=0)
    arc = arc[arc[:, 0] != arc[:, 1]].astype(np.int32)
    return {"arc": arc, "id": np.array([[0]], np.int32)}
'''

#: a per-layer reader of one span
STRATA_READER = '''from bench.harness.spans import per_evaluation


def read(records):
    return per_evaluation(records, lambda s: 1, "stratum.eval")
'''

CONFIGS = {
    "cc-tiny": {"program": CC, "idb": "cc2", "nodes": 256,
                "edb": {"generator": "rmat_graph", "args": {"n_log2": 8}},
                "reference": {"kind": "cc_labels", "edge": "arc"}},
    # the same labels read from CC's recursive MIN table, a dense handle
    "cc3-tiny": {"program": CC, "idb": "cc3", "nodes": 256,
                 "edb": {"generator": "rmat_graph", "args": {"n_log2": 8}},
                 "reference": {"kind": "cc_labels", "edge": "arc"}},
    "reach-tiny": {"program": REACH, "idb": "reach", "nodes": 256,
                   "edb": {"generator": "tiny_reach", "args": {"n": 256, "m": 400}},
                   "reference": {"kind": "reach_set", "edge": "arc", "start": "id"}},
}
CELLS = [f"{name}.eval" for name in CONFIGS]
SEED = 2**31 + 41


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny root with the three configurations above, their references,
    REACH's generator, one reader and their cells, added as new files and
    new entries only; the bytes of every file the benchmark had are checked
    unchanged."""
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    bench_dir = root / "bench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    new_files = {
        "reference/cc_labels.py": CC_REFERENCE,
        "reference/reach_set.py": REACH_REFERENCE,
        "data/tiny_reach.py": REACH_GENERATOR,
        "metrics/strata.eval.py": STRATA_READER,
    }
    for name, cfg in CONFIGS.items():
        new_files[f"configs/{name}.json"] = json.dumps(dict(cfg, engine={}))
    for rel, text in new_files.items():
        assert not (bench_dir / rel).exists()
        (bench_dir / rel).write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in CONFIGS:
        bench["configs"].append({"name": name, "source": "tiny", "reduced": [],
                                 "file": f"bench/configs/{name}.json", "why": "CPU tests"})
        bench["workloads"].append({"name": f"{name}.eval", "config": name, "traffic": "eval",
                                   "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tc-g10k.eval" in m.get("workloads", ()):
            m["workloads"] += CELLS
    bench["per_layer"].append({"name": "strata.eval", "unit": "count", "better": "lower",
                               "source": "program_span", "layer": "engine loop",
                               "moves": "eval_s", "workloads": CELLS})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    return root


def _run(root, name, trace=False, program=None):
    return cell.run(name, SEED, 0.3, trace, t_start=time.perf_counter(), root=root,
                    device="cpu", program=program)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_keyed_cell_from_new_files_is_correct(root, name, trace):
    r = _run(root, name, trace)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"missing_facts", "extra_facts", "duplicate_rows",
                                "count_off_max", "iterations_off_max", "failed_evaluations"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    if trace:
        strata = 3 if name.startswith("cc") else 1
        assert r["metrics"]["strata.eval"]["value"] == strata
    else:
        assert set(r["metrics"]) == {"setup_s", "eval_s", "peak_dev_gib"}


def test_the_references_agree_with_the_port_on_cc(root):
    """The test's own reference: labels by reachability equal those the
    rounds of propagation reach, and the port's, on the RMAT graph."""
    from repro_torch.core import Engine, EngineConfig

    from bench.harness import inputs
    from bench.harness.spec import load_cell

    c = load_cell("cc-tiny.eval", root)
    data = inputs.make(c.config, c.traffic, SEED, root)
    ref_mod = reference("cc_labels", root)
    ref = ref_mod.fixpoint(data.edb, c.config["reference"], data.n, "cpu")
    rounds = ref_mod.fixpoint(data.edb, c.config["reference"], data.n, "cpu",
                              max_rounds=ref.rounds)
    assert ref.rounds > 1 and torch.equal(ref.keys, rounds.keys)
    assert torch.equal(ref.values, rounds.values)
    engine = Engine(EngineConfig(), device="cpu")
    engine.run(CC, data.edb, return_numpy=False)
    cc2 = engine.take_store()["cc2"]
    rows = cc2.rows[: cc2.count]
    assert torch.equal(rows[:, 0].long(), ref.keys) and torch.equal(rows[:, 1].long(), ref.values)
    assert engine.stats.total_iterations() == ref.expected_iterations("tuple")


class _Faulty:
    """The engine's program with one fault planted in what it produced."""

    def __init__(self, root, name, fault):
        from bench.harness.spec import load_cell

        self.inner = evalcell.EngineProgram(load_cell(name, root).config, "cpu")
        self.fault = fault

    def __call__(self, text, edb):
        ev = self.inner(text, edb)
        return self.fault(ev)


def _rows(ev, rows):
    return dataclasses.replace(ev, rows=rows, handle=None, count=len(rows))


def label_off_by_one(ev):
    rows = ev.judged_rows().clone()
    rows[len(rows) // 2, 1] += 1
    return _rows(ev, rows)


def node_missing(ev):
    rows = ev.judged_rows()
    return _rows(ev, torch.cat([rows[:3], rows[4:]]))


def row_repeated(ev):
    rows = ev.judged_rows()
    return _rows(ev, torch.cat([rows, rows[-1:]]))


def extra_node(ev):
    rows = ev.judged_rows()
    free = sorted(set(range(256)) - set(rows[:, 0].tolist()))[0]
    extra = rows[:1].clone()
    extra[0, 0] = free
    return _rows(ev, torch.cat([rows, extra]))


def round_short(ev):
    return dataclasses.replace(ev, iterations=ev.iterations - 1)


#: fault → the check it must move
FAULTS = {label_off_by_one: "missing_facts", node_missing: "missing_facts",
          row_repeated: "duplicate_rows", extra_node: "extra_facts",
          round_short: "iterations_off_max"}


@pytest.mark.parametrize(("name", "fault"), [
    (name, fault) for name in CELLS for fault in FAULTS
    if not (fault is label_off_by_one and name.startswith("reach"))     # a set has no labels
], ids=lambda v: getattr(v, "__name__", v))
def test_a_planted_fault_is_not_correct(root, name, fault):
    r = _run(root, name, program=_Faulty(root, name, fault))
    assert r["correct"] is False
    assert r["checks"][FAULTS[fault]]["value"] > 0, r["checks"]


def test_a_fault_in_the_dense_handle_is_not_correct(root, monkeypatch):
    """A member dropped from REACH's membership vector where the engine
    leaves it: the check reads the handle after the window and finds it."""
    from repro_torch.core import engine

    real_take = engine.Engine.take_store

    def take(self):
        store = real_take(self)
        member = store["reach"].member
        member[torch.nonzero(member)[-1]] = False
        return store

    monkeypatch.setattr(engine.Engine, "take_store", take)
    r = _run(root, "reach-tiny.eval")
    assert r["correct"] is False and r["checks"]["missing_facts"]["value"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(root, name):
    from bench.control import control_run

    r = control_run(name, SEED + 1, 0.3, "cpu", root=root)
    assert r["correct"] is False
    assert r["checks"]["missing_facts"]["value"] > 0


# -- the keyed comparison, by hand ---------------------------------------------------

@dataclasses.dataclass
class _Ref:
    keys: torch.Tensor
    values: torch.Tensor | None
    rounds: int = 0

    @property
    def count(self):
        return len(self.keys)


LABELS = _Ref(torch.tensor([1, 4, 7]), torch.tensor([1, 1, 4]))

#: program rows → (missing, extra, duplicate) against LABELS
BY_HAND = {
    "same": ([(1, 1), (4, 1), (7, 4)], (0, 0, 0)),
    "unsorted": ([(7, 4), (1, 1), (4, 1)], (0, 0, 0)),
    "wrong value": ([(1, 1), (4, 2), (7, 4)], (1, 1, 0)),
    "missing key": ([(1, 1), (7, 4)], (1, 0, 0)),
    "extra key": ([(1, 1), (4, 1), (5, 1), (7, 4)], (0, 1, 0)),
    "repeated row": ([(1, 1), (4, 1), (4, 1), (7, 4)], (0, 0, 1)),
    "key twice, one wrong": ([(1, 1), (4, 1), (4, 3), (7, 4)], (0, 1, 1)),
    "key below and above": ([(0, 1), (1, 1), (4, 1), (7, 4), (9, 4)], (0, 2, 0)),
    "nothing": ([], (3, 0, 0)),
}


@pytest.mark.parametrize("case", sorted(BY_HAND))
def test_keyed_gap_by_hand(case):
    rows, (missing, extra, dup) = BY_HAND[case]
    t = torch.tensor(rows, dtype=torch.int32).reshape(-1, 2)
    gap = check.keyed_gap(t, LABELS)
    assert gap == {"missing_facts": missing, "extra_facts": extra, "duplicate_rows": dup}
    assert check.idb_gap(t, LABELS) == gap


def test_keyed_gap_of_keys_alone_and_of_an_empty_reference():
    members = _Ref(torch.tensor([2, 3]), None)
    rows = torch.tensor([[3], [5], [3]], dtype=torch.int32)
    assert check.keyed_gap(rows, members) == {
        "missing_facts": 1, "extra_facts": 1, "duplicate_rows": 1}
    empty = _Ref(torch.zeros(0, dtype=torch.int64), None)
    assert check.keyed_gap(rows, empty) == {
        "missing_facts": 0, "extra_facts": 3, "duplicate_rows": 1}


def test_a_closure_still_goes_through_closure_gap():
    closure = reference("linear_closure").fixpoint(
        {"arc": np.array([[0, 1], [1, 2]], np.int32)},
        {"base": "arc", "step": "arc"}, 3, "cpu")
    rows = torch.tensor([[0, 1], [0, 2], [1, 2], [1, 2]], dtype=torch.int32)
    assert check.idb_gap(rows, closure) == check.closure_gap(rows, closure) == {
        "missing_facts": 0, "extra_facts": 0, "duplicate_rows": 1}
    assert check.reference_iterations(closure, "bitmatrix") == closure.rounds + 1
    assert check.reference_iterations(closure, "tuple") == closure.rounds + 2


def test_a_dense_handle_is_read_as_rows():
    from repro_torch.core.relation import DenseAggRelation, DenseSetRelation

    table = DenseAggRelation.empty("cc3", 6, "MIN", "cpu").update(
        torch.tensor([4, 1, 4, 2]), torch.tensor([3, 0, 2, 5]), torch.tensor([1, 1, 1, 0]).bool())
    ev = evalcell.Evaluation(rows=None, count=table.count, iterations=1, backend="dense_agg",
                             stratum_s=0.0, handle=table)
    assert ev.judged_rows().tolist() == [[1, 0], [4, 2]]
    assert ev.judged_rows().dtype == torch.int32
    members = DenseSetRelation.empty("reach", 5, "cpu").update(
        torch.tensor([3, 0, 3]), torch.tensor([1, 1, 1]).bool())
    ev = dataclasses.replace(ev, handle=members, count=members.count)
    assert ev.judged_rows().tolist() == [[0], [3]]
