"""Traffic of kind ``eval``: one client in a closed loop runs whole
evaluations back to back.

Each evaluation is a fresh ``Engine(EngineConfig(**engine), device)`` that
receives the program as text and the EDB as host numpy arrays, runs to the
fixpoint with ``return_numpy=False`` and ends in a synchronise: the fixpoint
stays on the card, as RecStep leaves it in its tables.  Its store is taken,
and dropped before the next evaluation starts, except the window's last one,
which the check reads.  A tuple IDB is judged by its table's rows; a dense
one (a MIN/MAX table, a membership vector) is kept as its handle and read as
rows only after the window (``Evaluation.judged_rows``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.obs.trace import TRACER


@dataclass
class Evaluation:
    rows: torch.Tensor | None    # int32[count, arity] of a tuple IDB, on the device
    count: int
    iterations: int
    backend: str
    stratum_s: float             # sum of EvalStats.stratum_seconds
    store: dict = field(repr=False, default_factory=dict)
    handle: object = field(repr=False, default=None)    # a dense IDB, where rows is None

    def judged_rows(self) -> torch.Tensor:
        """The IDB as the check reads it, after the window: a tuple IDB's
        rows; a dense MIN/MAX table's present ``(key, value)`` pairs; a dense
        set's members as ``[count, 1]``; each int32, keys ascending."""
        if self.rows is not None:
            return self.rows
        h = self.handle
        if hasattr(h, "values"):             # absent keys hold ``h.absent``
            keys = torch.nonzero(h.values != h.absent).flatten()
            return torch.stack([keys.to(torch.int32), h.values[keys]], dim=1)
        return torch.nonzero(h.member).to(torch.int32)


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
        dense = not hasattr(handle, "rows")
        return Evaluation(
            rows=None if dense else handle.rows[: handle.count], count=handle.count,
            iterations=engine.stats.total_iterations(),
            backend=engine.stats.backend_used.get(self.idb, "?"),
            stratum_s=sum(engine.stats.stratum_seconds.values()), store=store,
            handle=handle if dense else None,
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
