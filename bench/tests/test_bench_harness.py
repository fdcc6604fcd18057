"""The harness finds cells by name, takes new cells from new files alone,
and prints the contract's result line."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from bench.harness import cell
from bench.harness.spec import load_cell, metric_reader, reference
from bench.tests.tiny import ROOT, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"] and bench["command"] == ["python3", "bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len(configs) == len(bench["configs"]) and len(cells) == len(bench["workloads"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:
        own = [m for m in metrics if w in m.get("workloads", [w])]
        assert any(m in bench["per_layer"] for m in own)
        assert len([m for m in own if m in bench["end_to_end"]]) >= 2


def test_finds_configuration_traffic_and_metric_by_name():
    c = load_cell("tc-g10k.eval")
    assert c.config["name"] == "tc-g10k" and c.config["nodes"] == 10_000
    assert c.config["reduced"] == []
    assert c.traffic["kind"] == "eval"
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "eval_s", "peak_dev_gib"}
    assert "bitmm_roofline" in {m["name"] for m in c.per_layer}
    assert "txn_apply_ms.serve" not in {m["name"] for m in c.per_layer}
    read = metric_reader("prep_ms.eval")
    assert read({"kind": "eval", "evaluations": [
        {"host_s": 1.0, "stratum_s": 0.5, "iterations": 5},
        {"host_s": 0.5, "stratum_s": 0.25, "iterations": 5}]}) == pytest.approx(375.0)
    assert read({"kind": "serve"}) is None
    s = load_cell("tc-g10k.serve")
    assert s.traffic["kind"] == "serve"
    assert {m["name"] for m in s.end_to_end} == {"setup_s", "update_p95_ms", "peak_dev_gib"}
    assert "read_p99_ms.serve" in {m["name"] for m in s.per_layer}
    p99 = metric_reader("read_p99_ms.serve")
    assert p99({"kind": "serve", "reads": [{"latency_s": k / 1e3} for k in range(1, 201)]}) == 198
    assert p99({"kind": "eval", "evaluations": []}) is None
    assert reference("linear_closure").fixpoint is not None
    with pytest.raises(KeyError):
        load_cell("no-such.cell")


def test_a_cell_from_new_files_alone(root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with entries added to BENCHMARK.json: no file the benchmark has is
    edited, and the harness runs the cell."""
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*") if p.is_file()}
    (root / "bench" / "traffic" / "eval-pair.json").write_text(json.dumps(
        {"kind": "eval", "why": "two clients' worth: a new mix of a known kind"}))
    (root / "bench" / "metrics" / "evals_done.py").write_text(
        "def read(records):\n"
        "    evs = records.get('evaluations')\n"
        "    return float(len(evs)) if evs else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tc-tiny.eval-pair", "config": "tc-tiny",
                               "traffic": "eval-pair", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "evals_done", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "engine loop",
                               "moves": "eval_s", "workloads": ["tc-tiny.eval-pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    r = cell.run("tc-tiny.eval-pair", 11, 0.3, True, t_start=time.perf_counter(), root=root,
                 device="cpu")
    assert r["correct"] and r["metrics"]["evals_done"]["value"] >= 1


@pytest.mark.parametrize("name", ["tc-tiny.eval", "tc-tiny.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_fields(root, name, trace):
    r = cell.run(name, 2**31 + 3, 0.3, trace, t_start=time.perf_counter(), root=root,
                 device="cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = load_cell(name, root)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if trace:   # the device's metrics and the spans' device times come only from the card
        want -= {"bitmm_roofline", "device_idle_pct.eval", "device_idle_pct.serve",
                 "to_rows_ms.eval", "lookup_ms.serve"}
    assert set(r["metrics"]) == want
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    json.dumps(r)


def test_same_seed_same_inputs_another_seed_another_order():
    from bench.harness import inputs

    c = load_cell("tc-g10k.serve")
    cfg = json.loads(json.dumps(c.config))
    cfg["edb"]["args"].update(n=500, p=0.01)
    cfg["nodes"] = 500
    a, b, d = (inputs.make(cfg, c.traffic, s) for s in (2**31 + 9, 2**31 + 9, 5))
    assert all((a.edb[k] == b.edb[k]).all() for k in a.edb)
    assert (a.held == b.held).all() and (a.read_keys == b.read_keys).all()
    assert len(a.edb["arc"]) == len(d.edb["arc"]) and len(a.held) == len(d.held)
    assert not (a.edb["arc"] == d.edb["arc"]).all()


def test_every_seed_holds_out_the_same_rows_of_the_instance():
    from bench.harness import inputs

    c = load_cell("tc-g10k.serve")
    cfg = json.loads(json.dumps(c.config))
    cfg["edb"]["args"].update(n=500, p=0.01)
    cfg["nodes"] = 500
    held = []
    for seed in (2**31 + 9, 5, 2**33 + 1):
        inv = np.argsort(inputs.rng_of(seed, 0).permutation(500))
        rows = inv[inputs.make(cfg, c.traffic, seed).held]
        held.append(rows[np.lexsort((rows[:, 1], rows[:, 0]))])
    assert all(np.array_equal(held[0], h) for h in held[1:])


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the command would run the cell")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", "tc-g10k.eval",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
