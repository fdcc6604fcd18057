"""Traffic of kind ``eval``: one client in a closed loop runs whole
evaluations back to back.

Each evaluation is a fresh ``Engine(EngineConfig(**engine), device)`` that
receives the program as text and the EDB as host numpy arrays, runs to the
fixpoint with ``return_numpy=False`` and ends in a synchronise: the fixpoint
stays on the card, as RecStep leaves it in its tables.  Its store is taken,
and dropped before the next evaluation starts, except the window's last one,
which the check reads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.obs.trace import TRACER


@dataclass
class Evaluation:
    rows: torch.Tensor           # int32[count, 2] of the IDB, on the device
    count: int
    iterations: int
    backend: str
    stratum_s: float             # sum of EvalStats.stratum_seconds
    store: dict = field(repr=False, default_factory=dict)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class EngineProgram:
    """The system under test: ``Engine.run`` of one configuration."""

    def __init__(self, config: dict, device):
        self.engine_args = config["engine"]
        self.idb = config["idb"]
        self.device = device

    def __call__(self, text: str, edb: dict) -> Evaluation:
        from repro_torch.core import Engine, EngineConfig

        engine = Engine(EngineConfig(**self.engine_args), device=self.device)
        engine.run(text, edb, return_numpy=False)
        sync(self.device)
        store = engine.take_store()
        handle = store[self.idb]
        return Evaluation(
            rows=handle.rows[: handle.count], count=handle.count,
            iterations=engine.stats.total_iterations(),
            backend=engine.stats.backend_used.get(self.idb, "?"),
            stratum_s=sum(engine.stats.stratum_seconds.values()), store=store,
        )


@dataclass
class EvalWindow:
    records: list[dict]          # per evaluation: host_s, stratum_s, iterations, count
    last: Evaluation | None
    window_s: float
    failed: int
    errors: list[str]


def window(evaluate: Callable, text: str, edb: dict, seconds: float) -> EvalWindow:
    """Evaluations back to back until ``seconds`` have passed; the last one
    started counts whole."""
    records, errors, last, failed = [], [], None, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        last = None
        t = time.perf_counter()
        try:
            with TRACER.span("bench.evaluation", "bench"):
                last = evaluate(text, edb)
        except Exception as e:      # noqa: BLE001 -- a failed evaluation is counted, not fatal
            failed += 1
            errors.append(f"{type(e).__name__}: {e}"[:500])
        else:
            records.append({"host_s": time.perf_counter() - t, "stratum_s": last.stratum_s,
                            "iterations": last.iterations, "count": last.count,
                            "backend": last.backend})
        if time.perf_counter() >= deadline:
            break
    return EvalWindow(records, last, time.perf_counter() - t0, failed, errors)


def bitmm_replay(evaluate: Callable, text: str, edb: dict, n: int,
                 evaluations: int = 2) -> list[tuple[float, float]]:
    """``(bound_s, event_s)`` of every ``bitmm`` product in ``evaluations``
    more evaluations, each product between two CUDA events on its stream.
    A's words are copied beside each call, outside the events, and the
    bounds are worked out once the evaluation is done."""
    from bench.harness.peaks import bitmm_bound_s
    from repro_torch.core import bitmatrix

    calls = []
    saved = bitmatrix.bitmm, bitmatrix.bitmm_fused_delta

    def timed(fn, c_arrays):
        def call(a, b, *rest):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(a, b, *rest)
            end.record()
            cols = n if b.shape[1] == -(-n // 32) else b.shape[1] * 32
            calls.append((a.clone(), cols, c_arrays, start, end))
            return out
        return call

    out = []
    bitmatrix.bitmm = timed(saved[0], 1)
    bitmatrix.bitmm_fused_delta = timed(saved[1], 3)
    try:
        for _ in range(evaluations):
            result = evaluate(text, edb)
            del result
            torch.cuda.synchronize()
            for a, cols, c_arrays, start, end in calls:
                out.append((bitmm_bound_s(a, cols, c_arrays), start.elapsed_time(end) / 1e3))
            calls.clear()
    finally:
        bitmatrix.bitmm, bitmatrix.bitmm_fused_delta = saved
    return out
