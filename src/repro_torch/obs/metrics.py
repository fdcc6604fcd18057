"""Metrics registry: counters, gauges, fixed-bucket histograms.

One registry unifies the stats that previously lived on scattered surfaces
(``ServerStats``, ``mvcc_stats()``, ``durability_stats()``, ``update_log``):
``DatalogServer.metrics()`` snapshots it as JSON and
``DatalogServer.metrics_prometheus()`` renders Prometheus text exposition.

Update paths are lock-cheap: each instrument has its own small lock held
only for the arithmetic (counters/histograms), and gauges can be backed by
a zero-state callback read at collection time — the serving hot path never
touches a shared registry lock.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Sequence


#: Default histogram buckets (seconds) — Prometheus' classic latency ladder.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    """Monotonically increasing count."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: ``set()`` it, or back it with a callback that is
    read at collection time (queue depth, reader pins, current epoch)."""

    def __init__(self, name: str, help: str = "", fn: Callable[[], float] | None = None):
        self.name = name
        self.help = help
        self._fn = fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le``-inclusive semantics.

    ``buckets`` are upper bounds in ascending order; an implicit ``+Inf``
    bucket catches the tail.  ``observe`` is a bisect + two adds under a
    per-instrument lock.  ``percentile`` answers from bucket upper bounds
    (the classic histogram-quantile estimate — exact only up to bucket
    resolution).
    """

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        bounds = tuple(sorted(buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"duplicate bucket bounds in {bounds}")
        self.name = name
        self.help = help
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)   # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)    # le-inclusive: v == bound lands in it
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative: list[int] = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return {
            "buckets": {
                **{str(b): cumulative[i] for i, b in enumerate(self.bounds)},
                "+Inf": cumulative[-1],
            },
            "sum": s,
            "count": total,
        }

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile from bucket upper bounds.

        Returns 0.0 with no observations; the +Inf bucket reports the
        largest finite bound (there is nothing better to say).
        """
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        rank = max(int(q * total + 0.9999999), 1)   # ceil without float drama
        running = 0
        for i, c in enumerate(counts):
            running += c
            if running >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]


def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted(labels.items())) if labels else ()


def _escape_label_value(v) -> str:
    # text-format spec: label values escape backslash, double-quote, newline
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    # HELP lines escape backslash and newline (but not double-quote)
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(labels: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Named instruments, get-or-create, with JSON and Prometheus exports."""

    def __init__(self):
        self._lock = threading.Lock()
        # (name, sorted-label-tuple) → instrument
        self._instruments: dict[tuple, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, labels: dict | None, factory):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = factory()
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str, help: str = "", labels: dict | None = None) -> Counter:
        return self._get_or_create(Counter, name, labels, lambda: Counter(name, help))

    def gauge(
        self,
        name: str,
        help: str = "",
        labels: dict | None = None,
        fn: Callable[[], float] | None = None,
    ) -> Gauge:
        g = self._get_or_create(Gauge, name, labels, lambda: Gauge(name, help, fn=fn))
        if fn is not None:
            g._fn = fn
        return g

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: dict | None = None,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, labels, lambda: Histogram(name, help, buckets=buckets)
        )

    # -- exports -------------------------------------------------------------

    def _items(self) -> list[tuple[str, tuple, Counter | Gauge | Histogram]]:
        with self._lock:
            items = [(n, lk, inst) for (n, lk), inst in self._instruments.items()]
        items.sort(key=lambda t: (t[0], t[1]))
        return items

    def snapshot(self) -> dict:
        """JSON-serialisable dict: ``name{k="v"}`` → value/histogram dict."""
        out: dict = {}
        for name, labels, inst in self._items():
            key = name + _render_labels(labels)
            if isinstance(inst, Histogram):
                out[key] = inst.snapshot()
            else:
                out[key] = inst.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        seen_header: set[str] = set()
        for name, labels, inst in self._items():
            kind = (
                "counter" if isinstance(inst, Counter)
                else "gauge" if isinstance(inst, Gauge)
                else "histogram"
            )
            if name not in seen_header:
                seen_header.add(name)
                if inst.help:
                    lines.append(f"# HELP {name} {_escape_help(inst.help)}")
                lines.append(f"# TYPE {name} {kind}")
            if isinstance(inst, Histogram):
                snap = inst.snapshot()
                for bound, cum in snap["buckets"].items():
                    le = _render_labels(labels, f'le="{bound}"')
                    lines.append(f"{name}_bucket{le} {cum}")
                lbl = _render_labels(labels)
                lines.append(f"{name}_sum{lbl} {_fmt(snap['sum'])}")
                lines.append(f"{name}_count{lbl} {snap['count']}")
            else:
                lines.append(f"{name}{_render_labels(labels)} {_fmt(inst.value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Integral floats print as ints — matches common exposition style.

    Non-finite values use the exposition-format spellings ``+Inf`` /
    ``-Inf`` / ``NaN`` (Python's ``repr`` says ``inf``/``nan``, which
    Prometheus parsers reject).
    """
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return str(int(v)) if v.is_integer() and abs(v) < 1e15 else repr(v)
