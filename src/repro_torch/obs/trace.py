"""Span tracer: low-overhead, thread-aware, Chrome-trace exportable.

The engine, serving, and persistence layers are instrumented with spans
(``with TRACER.span("stratum", index=2): ...``) so one request's whole
lifecycle — enqueue → admission → per-stratum/per-iteration/per-rule
evaluation → WAL fsync → epoch publish → reply — renders as a nested
timeline in ``chrome://tracing`` / Perfetto via :meth:`Tracer.export_chrome`.

Design constraints (this code sits inside the semi-naïve inner loop):

* **Disabled fast path** — tracing is off by default.  ``span()`` and
  ``device_span()`` then do one attribute read and return a process-wide
  no-op singleton; nothing is allocated that survives the call (see
  ``tests/test_torch_trace.py``'s tracemalloc guard).
* **Monotonic clocks** — spans stamp ``time.perf_counter_ns``; wall-clock
  jumps never corrupt durations.  :meth:`Tracer.enable` keeps one
  ``(time.time_ns(), perf_counter_ns())`` anchor, through which the export
  stamps Unix-epoch microseconds, the clock of ``torch.profiler``'s Chrome
  traces, so the two overlay in Perfetto.
* **Device time** — :meth:`Tracer.device_span` records a pair of CUDA events
  on the current stream (the serving writer's own stream on its thread) at
  open and close.  Nothing waits on them while the program runs;
  :meth:`Tracer.spans` resolves ``device_ns`` once each end event is done.
* **Host syncs** — while tracing is on, every host synchronisation the
  calling thread makes is counted: PyTorch's sync debug mode warns on each
  implicit one (``.item()``, ``int(t)``, ``.cpu()``, ``nonzero``, a stream's
  ``synchronize``) and the warning is counted, never shown; the port's
  explicit ``torch.cuda.synchronize`` calls count themselves
  (:meth:`Tracer.count_sync`).  Each span's ``syncs`` is the count inside
  it, its children's included.
* **Thread-aware** — each thread records into its own bounded ring buffer
  (appends are single-threaded by construction, no lock on the hot path)
  and keeps its own open-span stack and sync count, so parenting never
  crosses threads: the server's writer thread, checkpointer thread, and
  reader threads each produce an independent, correctly-nested lane in the
  export.
* **Bounded** — per-thread buffers keep the newest ``max_spans_per_thread``
  finished spans; a long-lived server cannot accumulate unbounded trace
  state while tracing stays on.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import warnings
from typing import Any

#: Spans of the port that the reference's tracer does not record: the front
#: end's, the tuple path's and dense MIN/MAX table's operators, PBME's and
#: the serving instance's phases.  Span-for-span parity with the reference,
#: and the ANALYZE profile trees, leave them out.
PORT_ONLY_SPANS = frozenset({
    "engine.prep", "engine.parse", "engine.analyze", "engine.domain",
    "edb.upload", "edb.dedup",
    "agg.propagate", "agg.groupby", "join", "membership",
    "uie.dedup", "dsd", "idb.merge",
    "pbme.build", "pbme.fixpoint", "pbme.transpose", "pbme.mask", "pbme.to_rows",
    "recompute.diff",
    "query.wait", "query.lookup",
})

#: the text of PyTorch's warning on a synchronising CUDA operation
_SYNC_WARNING = "called a synchronizing CUDA operation"

_NO_ATTRS: dict = {}


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
    """One timed region on one thread; use via ``with tracer.span(...)``.

    ``device_ns`` is the device time between the span's CUDA events (a
    :meth:`Tracer.device_span` on a CUDA device, once resolved), else
    ``None``; ``syncs`` the host synchronisations inside it."""

    __slots__ = (
        "name", "cat", "args", "start_ns", "dur_ns",
        "tid", "span_id", "parent_id", "_tracer",
        "device_ns", "syncs", "_sync0", "_events",
    )

    def __init__(self):
        self.args: dict[str, Any] = {}
        self.dur_ns = -1          # -1 = still open (or an instant event)
        self.device_ns: int | None = None
        self.syncs = 0
        self._events = None       # (start, end, stream) until resolved

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
    """Per-thread ring buffer + open-span stack + sync count (created on
    first touch)."""

    def __init__(self):
        self.buf: list[Span] | None = None
        self.stack: list[Span] = []
        self.syncs = 0


class Tracer:
    """Process-wide span recorder with a Chrome trace-event exporter."""

    def __init__(self, max_spans_per_thread: int = 4096):
        self.enabled = False
        self.max_spans_per_thread = max_spans_per_thread
        self._lock = threading.Lock()
        # one buffer per live thread that has recorded (append-only from
        # its owner, snapshot by slice from the exporter); a thread that has
        # exited hands its spans to ``_retired``, one buffer of the same
        # bound, so a writer thread a transaction keeps its spans after its
        # ident is reused
        self._buffers: dict[int, tuple[threading.Thread, list[Span]]] = {}
        self._retired: list[Span] = []
        self._names: dict[int, str] = {}      # tid → thread name, for export
        self._next_buffer = itertools.count().__next__
        self._local = _ThreadState()
        self._next_id = itertools.count(1).__next__
        self._anchor = (time.time_ns(), time.perf_counter_ns())
        self._cuda = False            # CUDA present: device spans take events
        self._sync_watch = None       # (catch_warnings, debug mode before)

    # -- control -------------------------------------------------------------

    def enable(
        self, max_spans_per_thread: int | None = None, clear: bool = True
    ) -> None:
        if max_spans_per_thread is not None:
            self.max_spans_per_thread = max_spans_per_thread
        if clear:
            self.clear()
        self._anchor = (time.time_ns(), time.perf_counter_ns())
        self._cuda = _cuda_available()
        if self._cuda and self._sync_watch is None:
            self._watch_syncs()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False
        if self._sync_watch is not None:
            import torch

            catch, mode = self._sync_watch
            self._sync_watch = None
            torch.cuda.set_sync_debug_mode(mode)
            catch.__exit__(None, None, None)

    def clear(self) -> None:
        """Drop every recorded span (open-span stacks are per-thread and
        survive; their spans record when they close if tracing is on)."""
        with self._lock:
            for _thread, buf in self._buffers.values():
                del buf[:]
            del self._retired[:]

    def _watch_syncs(self) -> None:
        """Turn on PyTorch's warning on synchronising CUDA operations and
        count each one on its thread instead of showing it.  A debug mode
        set by the caller (``"error"``) is left as it is."""
        import torch

        mode = torch.cuda.get_sync_debug_mode()
        if mode != 0:
            return
        catch = warnings.catch_warnings()
        catch.__enter__()
        shown = warnings.showwarning
        local = self._local

        def count_or_show(message, category, *rest, **kw):
            if str(message).startswith(_SYNC_WARNING):
                local.syncs += 1
            else:
                shown(message, category, *rest, **kw)

        warnings.filterwarnings("always", message=_SYNC_WARNING, category=UserWarning)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        warnings.showwarning = count_or_show
        torch.cuda.set_sync_debug_mode("warn")
        self._sync_watch = (catch, mode)

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
        st = self._local
        stack = st.stack
        sp.parent_id = stack[-1].span_id if stack else 0
        stack.append(sp)
        sp._sync0 = st.syncs
        sp.start_ns = time.perf_counter_ns()
        return sp

    def device_span(self, name: str, cat: str, device, **attrs) -> "Span | _NoopSpan":
        """:meth:`span` that also takes the device time between its open
        and its close: a pair of CUDA events on ``device``'s current stream.
        On a CPU device it is a plain span and ``device_ns`` stays ``None``."""
        if not self.enabled:
            return NOOP_SPAN
        sp = self.span(name, cat, **attrs)
        if self._cuda:
            import torch

            if torch.device(device).type == "cuda":
                stream = torch.cuda.current_stream(device)
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                sp._events = (start, torch.cuda.Event(enable_timing=True), stream)
        return sp

    def count_sync(self) -> None:
        """Count an explicit host synchronisation (``torch.cuda.synchronize``)
        on the calling thread; the sync debug mode sees only implicit ones."""
        if self.enabled:
            self._local.syncs += 1

    def inherit(self, key: str) -> dict:
        """``{key: value}`` of the innermost open span on this thread that
        carries ``key`` (a request's ``rid``, for the spans nested in its
        ``query``), or an empty dict; always empty while tracing is off."""
        if not self.enabled:
            return _NO_ATTRS
        for sp in reversed(self._local.stack):
            if key in sp.args:
                return {key: sp.args[key]}
        return _NO_ATTRS

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
        if sp._events is not None:
            sp._events[1].record(sp._events[2])
        st = self._local
        sp.dur_ns = time.perf_counter_ns() - sp.start_ns
        sp.syncs = st.syncs - sp._sync0
        stack = st.stack
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
            me = threading.current_thread()
            with self._lock:
                for key, (thread, buf) in list(self._buffers.items()):
                    if not thread.is_alive():
                        del self._buffers[key]
                        self._retired.extend(buf[-self.max_spans_per_thread:])
                del self._retired[: -self.max_spans_per_thread]
                self._buffers[self._next_buffer()] = (me, st.buf)
                self._names[me.ident] = me.name
        st.buf.append(sp)
        if len(st.buf) > 2 * self.max_spans_per_thread:
            del st.buf[: -self.max_spans_per_thread]

    # -- export --------------------------------------------------------------

    def spans(self) -> list[Span]:
        """Snapshot of recorded spans across all threads, by start time.

        A finished device span's ``device_ns`` is resolved here, waiting on
        its end event if the device has not reached it yet."""
        with self._lock:
            bufs = [buf for _thread, buf in self._buffers.values()]
            out: list[Span] = list(self._retired)
        for buf in bufs:
            out.extend(buf[-self.max_spans_per_thread:])
        for sp in out:
            ev = sp._events
            if ev is not None and sp.dur_ns >= 0:
                ev[1].synchronize()
                sp.device_ns = round(ev[0].elapsed_time(ev[1]) * 1e6)
                sp._events = None
        out.sort(key=lambda s: s.start_ns)
        return out

    def export_chrome(self, path: str | None = None) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` array format).

        Finished spans become complete events (``ph: "X"``, ts/dur in µs,
        ``ts`` on the Unix epoch through the anchor of :meth:`enable`);
        instants become ``ph: "i"``; each thread gets a ``thread_name``
        metadata event so Perfetto labels the writer/checkpointer lanes.
        Span attributes ride in ``args``, with ``span_id``/``parent_id`` for
        programmatic nesting checks, ``syncs``, and ``device_ms`` on device
        spans.  Pass ``path`` to also write the JSON to disk.
        """
        pid = os.getpid()
        wall0, perf0 = self._anchor
        events: list[dict] = []
        with self._lock:
            names = dict(self._names)
        for tid, name in names.items():
            events.append(
                {
                    "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": name},
                }
            )
        for sp in self.spans():
            args = dict(sp.args, span_id=sp.span_id, parent_id=sp.parent_id,
                        syncs=sp.syncs)
            if sp.device_ns is not None:
                args["device_ms"] = sp.device_ns / 1e6
            ev = {
                "name": sp.name,
                "cat": sp.cat or "default",
                "ph": "X" if sp.dur_ns >= 0 else "i",
                "ts": (wall0 + sp.start_ns - perf0) / 1e3,
                "pid": pid,
                "tid": sp.tid,
                "args": args,
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


def _cuda_available() -> bool:
    """Whether PyTorch is loaded with a CUDA device (imports nothing)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_available()


#: The process-wide tracer every instrumented module records into.
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER
