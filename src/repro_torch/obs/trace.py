"""Span tracer: low-overhead, thread-aware, Chrome-trace exportable.

The engine, serving, and persistence layers are instrumented with spans
(``with TRACER.span("stratum", index=2): ...``) so one request's whole
lifecycle — enqueue → admission → per-stratum/per-iteration/per-rule
evaluation → WAL fsync → epoch publish → reply — renders as a nested
timeline in ``chrome://tracing`` / Perfetto via :meth:`Tracer.export_chrome`.

Design constraints (this code sits inside the semi-naïve inner loop):

* **Disabled fast path** — tracing is off by default.  ``span()`` then does
  one attribute read and returns a process-wide no-op singleton; nothing is
  allocated that survives the call, verified by ``tests/test_obs.py``'s
  tracemalloc guard and gated <3% on the serve benchmark in CI.
* **Monotonic clocks** — ``time.perf_counter_ns``; wall-clock jumps never
  corrupt durations.
* **Thread-aware** — each thread records into its own bounded ring buffer
  (appends are single-threaded by construction, no lock on the hot path)
  and keeps its own open-span stack, so parenting never crosses threads:
  the server's writer thread, checkpointer thread, and reader threads each
  produce an independent, correctly-nested lane in the export.
* **Bounded** — per-thread buffers keep the newest ``max_spans_per_thread``
  finished spans; a long-lived server cannot accumulate unbounded trace
  state while tracing stays on.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Callable


class _NoopSpan:
    """The disabled-mode span: a shared do-nothing context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region on one thread; use via ``with tracer.span(...)``."""

    __slots__ = (
        "name", "cat", "args", "start_ns", "dur_ns",
        "tid", "span_id", "parent_id", "_tracer",
    )

    def __init__(self):
        self.args: dict[str, Any] = {}
        self.dur_ns = -1          # -1 = still open (or an instant event)

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes; exported as Chrome-trace ``args``."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._finish(self)
        return False


class _ThreadState(threading.local):
    """Per-thread ring buffer + open-span stack (created on first touch)."""

    def __init__(self):
        self.buf: list[Span] | None = None
        self.stack: list[Span] = []


class Tracer:
    """Process-wide span recorder with a Chrome trace-event exporter."""

    def __init__(self, max_spans_per_thread: int = 4096):
        self.enabled = False
        self.max_spans_per_thread = max_spans_per_thread
        self._lock = threading.Lock()
        # tid → (thread name, buffer); buffers are append-only from their
        # owning thread, snapshot by slice from the exporter
        self._buffers: dict[int, tuple[str, list[Span]]] = {}
        self._local = _ThreadState()
        self._next_id = itertools.count(1).__next__
        self._t0_ns = time.perf_counter_ns()

    # -- control -------------------------------------------------------------

    def enable(
        self, max_spans_per_thread: int | None = None, clear: bool = True
    ) -> None:
        if max_spans_per_thread is not None:
            self.max_spans_per_thread = max_spans_per_thread
        if clear:
            self.clear()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop every recorded span (open-span stacks are per-thread and
        survive; their spans record when they close if tracing is on)."""
        with self._lock:
            for _name, buf in self._buffers.values():
                del buf[:]
        self._t0_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, cat: str = "", **attrs) -> "Span | _NoopSpan":
        """Open a span; close it via ``with`` (or ``__exit__``).

        Disabled tracing returns the shared :data:`NOOP_SPAN` immediately —
        the hot-path cost is one attribute check.
        """
        if not self.enabled:
            return NOOP_SPAN
        sp = Span()
        sp._tracer = self
        sp.name = name
        sp.cat = cat
        if attrs:
            sp.args.update(attrs)
        sp.tid = threading.get_ident()
        sp.span_id = self._next_id()
        stack = self._local.stack
        sp.parent_id = stack[-1].span_id if stack else 0
        stack.append(sp)
        sp.start_ns = time.perf_counter_ns()
        return sp

    def instant(self, name: str, cat: str = "", **attrs) -> None:
        """Record a zero-duration marker event (Chrome-trace ``ph: "i"``)."""
        if not self.enabled:
            return
        sp = Span()
        sp._tracer = self
        sp.name = name
        sp.cat = cat
        if attrs:
            sp.args.update(attrs)
        sp.tid = threading.get_ident()
        sp.span_id = self._next_id()
        stack = self._local.stack
        sp.parent_id = stack[-1].span_id if stack else 0
        sp.start_ns = time.perf_counter_ns()
        sp.dur_ns = -1
        self._record(sp)

    def _finish(self, sp: Span) -> None:
        sp.dur_ns = time.perf_counter_ns() - sp.start_ns
        stack = self._local.stack
        # ``with`` guarantees LIFO exit; tolerate a foreign stack anyway
        # (e.g. a span entered before enable() toggled mid-flight)
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            del stack[stack.index(sp):]
        self._record(sp)

    def _record(self, sp: Span) -> None:
        st = self._local
        if st.buf is None:
            st.buf = []
            with self._lock:
                self._buffers[threading.get_ident()] = (
                    threading.current_thread().name, st.buf,
                )
        st.buf.append(sp)
        if len(st.buf) > 2 * self.max_spans_per_thread:
            del st.buf[: -self.max_spans_per_thread]

    # -- decorator -----------------------------------------------------------

    def trace(self, name: str, cat: str = "") -> Callable:
        """Decorator form: ``@TRACER.trace("checkpoint")``."""

        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*a, **k):
                if not self.enabled:
                    return fn(*a, **k)
                with self.span(name, cat):
                    return fn(*a, **k)

            return wrapper

        return deco

    # -- export --------------------------------------------------------------

    def spans(self) -> list[Span]:
        """Snapshot of recorded spans across all threads, by start time."""
        with self._lock:
            bufs = [(name, buf) for name, buf in self._buffers.values()]
        out: list[Span] = []
        for _name, buf in bufs:
            out.extend(buf[-self.max_spans_per_thread:])
        out.sort(key=lambda s: s.start_ns)
        return out

    def export_chrome(self, path: str | None = None) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` array format).

        Finished spans become complete events (``ph: "X"``, ts/dur in µs);
        instants become ``ph: "i"``; each thread gets a ``thread_name``
        metadata event so Perfetto labels the writer/checkpointer lanes.
        Span attributes ride in ``args`` (plus ``span_id``/``parent_id``
        for programmatic nesting checks).  Pass ``path`` to also write the
        JSON to disk.
        """
        pid = os.getpid()
        t0 = self._t0_ns
        events: list[dict] = []
        with self._lock:
            names = {tid: name for tid, (name, _buf) in self._buffers.items()}
        for tid, name in names.items():
            events.append(
                {
                    "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": name},
                }
            )
        for sp in self.spans():
            ev = {
                "name": sp.name,
                "cat": sp.cat or "default",
                "ph": "X" if sp.dur_ns >= 0 else "i",
                "ts": (sp.start_ns - t0) / 1e3,
                "pid": pid,
                "tid": sp.tid,
                "args": dict(sp.args, span_id=sp.span_id, parent_id=sp.parent_id),
            }
            if sp.dur_ns >= 0:
                ev["dur"] = sp.dur_ns / 1e3
            else:
                ev["s"] = "t"          # instant scope: thread
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


#: The process-wide tracer every instrumented module records into.
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER
