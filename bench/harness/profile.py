"""Reading the device trace of a traced run.

``torch.profiler`` (CUDA activity: kernels, copies and sets on every stream)
records the window.  The busy time is the union of the device intervals, so
work on two streams at once (the serving writer's and the readers') counts
once.  Gaps between device intervals are named by the innermost span of
``repro_torch.obs.trace`` open on the host at the gap's middle: what the host
was doing while the device waited.
"""

from __future__ import annotations

import heapq
import time
from collections import Counter

import torch

TOP = 10


class DeviceTrace:
    """Context manager: profile the device over a window.

    Drives the profiler's own enable and disable calls, so that its result is
    read raw: ``torch.profiler.profile`` would first build an event tree of
    every kernel, which takes minutes over a window of a million launches."""

    def __enter__(self) -> "DeviceTrace":
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        from torch.autograd.profiler import (
            ProfilerConfig,
            ProfilerState,
            _enable_profiler,
            _prepare_profiler,
        )

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        torch.cuda.synchronize()
        _prepare_profiler(config, {ProfilerActivity.CUDA})
        _enable_profiler(config, {ProfilerActivity.CUDA})
        return self

    def __exit__(self, *exc) -> bool:
        from torch.autograd.profiler import _disable_profiler

        torch.cuda.synchronize()
        self._result = _disable_profiler()
        return False

    def device_events(self) -> list[tuple[int, int, str]]:
        """``(start, end, name)`` of every device event, in ns on the host's
        ``perf_counter_ns`` clock (the profiler stamps the system clock)."""
        from torch.autograd import DeviceType

        offset = time.time_ns() - time.perf_counter_ns()
        out = []
        for e in self._result.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() - offset
            out.append((start, start + e.duration_ns(), e.name()))
        return out


def reduce(events: list[tuple[int, int, str]], t0_ns: int, t1_ns: int,
           spans: list) -> dict:
    """``busy_s``, ``window_s``, and the ``breakdown`` of a window
    ``[t0_ns, t1_ns)`` from its device events and the host's spans."""
    by_name: Counter = Counter()
    for start, end, name in events:
        by_name[name[:120]] += (end - start) / 1e9
    merged: list[list[int]] = []
    for start, end, _ in sorted(events):
        start, end = max(start, t0_ns), min(end, t1_ns)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged)
    gaps, cursor = [], t0_ns
    for start, end in merged:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = end
    if cursor < t1_ns:
        gaps.append((cursor, t1_ns))
    idle = _name_gaps(gaps, spans)
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "breakdown": {
            "device_ops": [[k, v] for k, v in by_name.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)],
        },
    }


def _name_gaps(gaps: list[tuple[int, int]], spans: list) -> Counter:
    """Seconds of gap by the innermost (latest-started) span open at each
    gap's middle, on any thread; ``(no span)`` where none was open."""
    marks = sorted(((a + b) // 2, b - a) for a, b in gaps)
    spans = sorted((s for s in spans if s.dur_ns >= 0), key=lambda s: s.start_ns)
    out: Counter = Counter()
    open_: list[tuple[int, int, int, str]] = []       # heap by end: (end, -start, id, name)
    i = 0
    for mid, length in marks:
        while i < len(spans) and spans[i].start_ns <= mid:
            s = spans[i]
            heapq.heappush(open_, (s.start_ns + s.dur_ns, -s.start_ns, s.span_id, s.name))
            i += 1
        while open_ and open_[0][0] <= mid:
            heapq.heappop(open_)
        name = max(open_, key=lambda o: -o[1])[3] if open_ else "(no span)"
        out[name] += length / 1e9
    return out
