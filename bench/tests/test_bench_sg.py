"""Same generation in the benchmark: its plain reference against fixpoints
worked by hand, and a tiny copy of ``sg-g10k`` run through the harness on the
CPU from new files alone, correct, with the control not correct."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from bench.harness import cell
from bench.harness.spec import load_cell, reference
from bench.tests.tiny import ROOT, tiny_root

sg = reference("same_generation").fixpoint
SPEC = {"kind": "same_generation", "edge": "arc"}

#: name → (arc, n, every fact, its x with sg(x, x), productive rounds after
#: the base)
BY_HAND = {
    # siblings 1-2 and 3-4; the cousins 3, 4 and 5 through sg(1, 2)
    "tree": ([(0, 1), (0, 2), (1, 3), (1, 4), (2, 5)], 6,
             {(1, 2), (2, 1), (3, 4), (4, 3), (3, 5), (5, 3), (4, 5), (5, 4)}, set(), 1),
    # 0 -> 1 -> 2 -> 0 with the chord 0 -> 2: base (1, 2), (2, 1); then
    # (2, 0), (0, 2); (0, 1), (1, 0); (2, 2); (0, 0); (1, 1), one a round
    "cycle": ([(0, 1), (1, 2), (2, 0), (0, 2)], 3,
              {(x, y) for x in range(3) for y in range(3)}, {0, 1, 2}, 5),
    # 3's parents 1 and 2 are siblings, so 3 is its own cousin
    "own_cousin": ([(0, 1), (0, 2), (1, 3), (2, 3)], 4, {(1, 2), (2, 1), (3, 3)}, {3}, 1),
}


def facts(ref) -> set[tuple[int, int]]:
    idx, ys = np.nonzero(ref.bits.numpy())
    return {(int(ref.keys[i]), int(y)) for i, y in zip(idx, ys)}


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_same_generation_by_hand(name):
    arc, n, want, diagonal, rounds = BY_HAND[name]
    edb = {"arc": np.array(arc, np.int32)}
    ref = sg(edb, SPEC, n, "cpu")
    assert facts(ref) == want and ref.count == len(want) and ref.rounds == rounds
    assert {x for x, y in facts(ref) if x == y} == diagonal
    base = sg(edb, SPEC, n, "cpu", max_rounds=0)
    assert base.rounds == 0 and all(x != y for x, y in facts(base))
    short = sg(edb, SPEC, n, "cpu", max_rounds=rounds - 1)
    assert short.rounds == rounds - 1 and facts(short) < want


def test_row_and_digests_of_the_cycle():
    arc, n = BY_HAND["cycle"][:2]
    ref = sg({"arc": np.array(arc, np.int32)}, SPEC, n, "cpu")
    assert ref.keys.tolist() == [0, 1, 2] and ref.row(1).tolist() == [0, 1, 2]
    counts, sums = ref.row_digests()
    assert counts.tolist() == [3, 3, 3] and sums.tolist() == [3, 3, 3]


def test_the_configuration_is_found_by_name():
    c = load_cell("sg-g10k.eval")
    assert c.config["name"] == "sg-g10k" and c.config["reduced"] == []
    assert c.config["nodes"] == c.config["edb"]["args"]["n"] == 10_000
    assert c.config["reference"] == SPEC and c.traffic["kind"] == "eval"
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "eval_s", "peak_dev_gib"}
    assert {m["name"] for m in c.per_layer} == {
        "prep_ms.eval", "bitmm_roofline", "device_idle_pct.eval", "upload_ms.eval",
        "host_syncs.eval", "products.eval", "to_rows_ms.eval", "sg_prologue_ms.eval"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny root with ``sg-tiny``, ``sg-g10k.json`` at n = 300, and its
    ``eval`` cell added as a new file and new entries."""
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    cfg = json.loads((ROOT / "bench" / "configs" / "sg-g10k.json").read_text())
    cfg["edb"]["args"].update(n=300, p=0.01)
    cfg["nodes"] = 300
    (root / "bench" / "configs" / "sg-tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sg-tiny", "source": "tiny",
                             "file": "bench/configs/sg-tiny.json", "reduced": ["nodes"],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": "sg-tiny.eval", "config": "sg-tiny",
                               "traffic": "eval", "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sg-g10k.eval" in m.get("workloads", ()):
            m["workloads"].append("sg-tiny.eval")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_is_correct(root, trace):
    r = cell.run("sg-tiny.eval", 2**31 + 29, 0.3, trace, t_start=time.perf_counter(),
                 root=root, device="cpu")
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"missing_facts", "extra_facts", "duplicate_rows",
                                "count_off_max", "iterations_off_max", "failed_evaluations"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    # on the CPU the spans have no device time
    want = ({"prep_ms.eval", "upload_ms.eval", "host_syncs.eval", "products.eval"} if trace
            else {"setup_s", "eval_s", "peak_dev_gib"})
    assert set(r["metrics"]) == want


def test_the_control_is_not_correct(root):
    from bench.control import control_run

    r = control_run("sg-tiny.eval", 2**31 + 30, 0.3, "cpu", root=root)
    assert r["correct"] is False
    assert r["checks"]["missing_facts"]["value"] > 0
    assert r["checks"]["extra_facts"]["value"] == 0
