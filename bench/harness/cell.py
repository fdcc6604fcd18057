"""One run of one cell: set-up, the measured window, the traced window's
reduction, and the check against the plain reference.

``run`` returns the result line's object and the checks; ``bench/run.py``
prints them.  Tests call ``run`` with ``device="cpu"`` and a program of
their own in place of the system under test.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np
import torch

from bench.harness import check, evalcell, inputs, servecell
from bench.harness.peaks import percentile
from bench.harness.spec import ROOT, load_cell, metric_reader, reference

GIB = float(1 << 30)


def run(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        root: Path = ROOT, device: str = "cuda", program=None) -> dict:
    cell = load_cell(name, root)
    kind = cell.traffic["kind"]
    on_card = torch.device(device).type == "cuda"
    data = inputs.make(cell.config, cell.traffic, seed, root)
    drive = _eval if kind == "eval" else _serve
    out = drive(cell, data, seed, seconds, trace, t_start, device, on_card, program, root)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = (metric_reader(m["name"], root)(out["records"]) if trace
                 else out["e2e"].get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": check.verdict(out["checks"]) and out["attempted"] > out["failed"],
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace and "device" in out["records"]:
        dev.update(busy_s=out["records"]["device"]["busy_s"],
                   window_s=out["records"]["device"]["window_s"])
        result["breakdown"] = out["breakdown"]
    result["window"] = out["window"]
    result["checks"] = out["checks"]
    return result


# -- tracing around a window ---------------------------------------------------

class _Traced:
    """The traced run's instruments over a window: the spans of
    ``repro_torch.obs.trace`` and, on the card, the device trace.  ``spans``
    stays empty in an untraced run."""

    def __init__(self, on: bool, on_card: bool):
        self.on, self.on_card = on, on_card
        self.spans: list = []

    def __enter__(self):
        if self.on:
            from repro_torch.obs.trace import TRACER

            TRACER.enable(max_spans_per_thread=1 << 22)
            if self.on_card:
                from bench.harness.profile import DeviceTrace

                self.dt = DeviceTrace().__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.on:
            from repro_torch.obs.trace import TRACER

            if self.on_card:
                self.dt.__exit__(*exc)
            TRACER.disable()
            self.spans = TRACER.spans()
            TRACER.clear()
        return False

    def reduce(self, records: dict) -> dict:
        """Add the device's busy and window seconds to ``records``; return
        the breakdown."""
        if not (self.on and self.on_card):
            return {}
        from bench.harness.profile import reduce

        red = reduce(self.dt.device_events(), self.t0, self.t1, self.spans)
        records["device"] = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
        return red["breakdown"]


def _peak_reset(on_card: bool) -> int:
    """The process's peak so far, then a fresh peak for the window."""
    if not on_card:
        return 0
    torch.cuda.synchronize()
    before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return before


def _free(on_card: bool) -> None:
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# -- eval ------------------------------------------------------------------------

def _eval(cell, data, seed, seconds, trace, t_start, device, on_card, program, root) -> dict:
    cfg = cell.config
    text = cfg["program"]
    evaluate = program or evalcell.EngineProgram(cfg, device)
    warm = evaluate(text, data.edb)                 # builds and loads every kernel
    del warm
    _free(on_card)
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak_reset(on_card)
    with _Traced(trace, on_card) as tr:
        win = evalcell.window(evaluate, text, data.edb, seconds)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    records = {"kind": "eval", "evaluations": win.records, "spans": tr.spans}
    breakdown = tr.reduce(records)
    if trace and on_card:
        records["bitmm_calls"] = evalcell.bitmm_replay(evaluate, text, data.edb, data.n)
    e2e = {"setup_s": setup_s, "peak_dev_gib": window_peak / GIB}
    if win.records:
        e2e["eval_s"] = win.window_s / len(win.records)
    # the check: the reference after the window, on the same host inputs
    ref = reference(cfg["reference"]["kind"], root).fixpoint(data.edb, cfg["reference"], data.n,
                                                      device)
    gap = (check.idb_gap(win.last.judged_rows(), ref) if win.last is not None
           else {"missing_facts": ref.count, "extra_facts": 0, "duplicate_rows": 0})
    del win.last
    counts = [abs(r["count"] - ref.count) for r in win.records]
    iters = [abs(r["iterations"] - check.reference_iterations(ref, r["backend"]))
             for r in win.records]
    checks = check.exact(
        **gap, count_off_max=max(counts, default=0),
        iterations_off_max=max(iters, default=0), failed_evaluations=win.failed)
    return {"e2e": e2e, "records": records, "breakdown": breakdown, "checks": checks,
            "attempted": len(win.records) + win.failed, "failed": win.failed,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "window": {"seconds": win.window_s, "evaluations": len(win.records),
                       "errors": win.errors[:3]}}


# -- serve -------------------------------------------------------------------------

def _state_after(ops: list[str], j: int) -> str:
    """Which EDB holds after ``j`` of the writer's transactions, cycling
    ``ops`` from the whole EDB: ``"full"`` or ``"held_out"``."""
    return "full" if j == 0 or ops[(j - 1) % len(ops)] == "insert" else "held_out"


def _without(rows: np.ndarray, held: np.ndarray, n: int) -> np.ndarray:
    key = rows[:, 0].astype(np.int64) * n + rows[:, 1]
    gone = held[:, 0].astype(np.int64) * n + held[:, 1]
    return rows[~np.isin(key, gone)]


def _serve(cell, data, seed, seconds, trace, t_start, device, on_card, program, root) -> dict:
    cfg, traffic = cell.config, cell.traffic
    text, idb = cfg["program"], cfg["idb"]
    upd = cfg["serve"]["update"]["relation"]
    ops = traffic["writer"]["ops"]
    prog = program or servecell.ServerProgram(cfg, traffic, device)
    prog.start(text, data.edb)
    before = servecell.warm(prog, cfg, traffic, data.held, data.read_keys)
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak_reset(on_card)
    with _Traced(trace, on_card) as tr:
        win = servecell.window(prog, cfg, traffic, data.held, data.read_keys, seconds, seed)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    done_txns = [t for t in win.txns if "done" in t]
    answered = [r for r in win.reads if "done" in r]
    records = {
        "kind": "serve",
        "txns": [{"op": t["op"], "seconds": t["result"].seconds,
                  "latency_s": t["done"] - t["submitted"]}
                 for t in done_txns if not isinstance(t["result"], Exception)],
        "reads": [{"queued_s": win.queued_s[r["rid"]], "latency_s": r["done"] - r["submitted"]}
                  for r in answered if r["rid"] in win.queued_s],
        "spans": tr.spans,
    }
    breakdown = tr.reduce(records)
    e2e = {"setup_s": setup_s, "peak_dev_gib": window_peak / GIB}
    if done_txns:
        e2e["update_p95_ms"] = percentile(
            [(t["done"] - t["submitted"]) * 1e3 for t in done_txns], 95)
    # the program's final state, read, and the program freed before the reference
    final_idb = prog.relation(idb)
    final_upd = prog.relation(upd)
    prog.close()
    del prog
    _free(on_card)
    ref_mod = reference(cfg["reference"]["kind"], root)
    edb_held_out = dict(data.edb)
    edb_held_out[upd] = _without(data.edb[upd], data.held, data.n)
    states = {"full": data.edb, "held_out": edb_held_out}
    refs = {s: ref_mod.fixpoint(e, cfg["reference"], data.n, device) for s, e in states.items()}
    digests = {s: (r.keys.cpu().numpy(), *r.row_digests()) for s, r in refs.items()}
    wrong = 0
    for r in answered:
        if "error" in r:
            continue
        allowed = {_state_after(ops, before + j) for j in servecell.states_allowed(r, win.txns)}
        if not any(_reply_matches(r, refs[s], digests[s]) for s in allowed):
            wrong += 1
    txn_off = 0
    for t in done_txns:
        res = t["result"]
        if not isinstance(res, Exception):
            applied = res.removed if t["op"] == "delete" else res.inserted
            txn_off += abs(applied - len(data.held))
    final = _state_after(ops, before + len(done_txns))
    gap = check.idb_gap(torch.as_tensor(final_idb, device=device), refs[final])
    want_upd = states[final][upd]
    upd_off = len(final_upd) + len(want_upd) - 2 * len(
        np.intersect1d(final_upd[:, 0].astype(np.int64) * data.n + final_upd[:, 1],
                       want_upd[:, 0].astype(np.int64) * data.n + want_upd[:, 1]))
    failed = (sum(1 for r in answered if "error" in r)
              + sum(1 for t in done_txns if isinstance(t["result"], Exception)))
    unanswered = len(win.reads) - len(answered) + len(win.txns) - len(done_txns)
    checks = check.exact(
        wrong_replies=wrong, failed_requests=failed, unanswered=unanswered,
        txn_rows_off=txn_off, final_missing_facts=gap["missing_facts"],
        final_extra_facts=gap["extra_facts"], final_duplicate_rows=gap["duplicate_rows"],
        final_edb_rows_off=upd_off)
    return {"e2e": e2e, "records": records, "breakdown": breakdown, "checks": checks,
            "attempted": len(win.reads) + len(win.txns), "failed": failed + unanswered,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "window": {"seconds": win.window_s, "txns": len(win.txns), "reads": len(win.reads),
                       "latency_ms": _latencies(records)}}


def _latencies(records: dict) -> dict:
    """The 50th and 90th percentiles of each kind of transaction's latency
    and apply seconds, and the 50th, 90th and 99th of the reads' latency,
    in ms: what the tails are made of, in every run's result line."""
    out = {}
    for op in {t["op"] for t in records["txns"]}:
        lat = [t["latency_s"] * 1e3 for t in records["txns"] if t["op"] == op]
        app = [t["seconds"] * 1e3 for t in records["txns"] if t["op"] == op]
        out[op] = [percentile(lat, 50), percentile(lat, 90), percentile(app, 50),
                   percentile(app, 90)]
    if records["reads"]:
        lat = [r["latency_s"] * 1e3 for r in records["reads"]]
        out["read"] = [percentile(lat, 50), percentile(lat, 90), percentile(lat, 99)]
    return out


def _reply_matches(r: dict, ref, digest) -> bool:
    """A reply against one state: its size and sum of values, and where it
    was kept whole, its values."""
    keys, sizes, sums = digest
    i = int(np.searchsorted(keys, r["key"]))
    present = i < len(keys) and keys[i] == r["key"]
    size = int(sizes[i]) if present else 0
    total = int(sums[i]) if present else 0
    if not (r["keyed"] and r["size"] == size and r["sum"] == total):
        return False
    if "rows" in r:
        return np.array_equal(np.sort(r["rows"][:, 1]), ref.row(r["key"]))
    return True


