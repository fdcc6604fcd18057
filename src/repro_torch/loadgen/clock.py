"""Virtual time: a manually advanced clock + a sleep-free polling helper.

``DatalogServer(clock=...)`` accepts anything callable returning seconds.
On the real clock (the default, ``time.perf_counter``) admission decisions
depend on scheduler timing; on a :class:`VirtualClock` they depend only on
when the driver advances it — which is what makes a replayed arrival trace
produce the same shed/deadline verdicts on every machine, every run.

:func:`wait_until` replaces the ``while not pred: time.sleep(...)`` loops
that timing-sensitive serving tests used to hand-roll — one place to tune
the poll interval and the timeout, and a return value the caller must
assert on (a silent timeout is how those loops used to flake).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class VirtualClock:
    """A monotonic clock that advances only when told to.

    Usable wherever the server wants a clock: calling the instance returns
    the current virtual time, and :meth:`sleep` *advances* it (a virtual
    sleeper never blocks a thread — waiting costs virtual time, not wall
    time).  Thread-safe: the serving loop, the writer thread, and the
    scenario driver may all read while the driver advances.

    ::

        clock = VirtualClock()
        srv = DatalogServer(inst, limits=limits, clock=clock)
        clock.advance(0.5)          # half a virtual second passes
        srv.submit_query("tc", src=3, deadline=clock() + 0.1)
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        return self.now()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds; returns the new time."""
        if dt < 0:
            raise ValueError(f"time only moves forward (dt={dt})")
        with self._lock:
            self._now += dt
            return self._now

    def advance_to(self, t: float) -> float:
        """Move time forward to ``t`` (no-op if ``t`` is in the past)."""
        with self._lock:
            self._now = max(self._now, float(t))
            return self._now

    def sleep(self, dt: float) -> None:
        """A sleeper on virtual time just advances the clock."""
        self.advance(max(dt, 0.0))


def sleep_on(clock, dt: float) -> None:
    """Sleep ``dt`` seconds on whatever clock the server runs on.

    A :class:`VirtualClock` (anything with a ``sleep`` attribute) advances;
    the real clock blocks the thread.  This is the one place retry backoff
    and test helpers decide which kind of waiting they are doing.
    """
    sleeper = getattr(clock, "sleep", None)
    if sleeper is not None:
        sleeper(dt)
    else:
        time.sleep(dt)


def wait_until(
    pred: Callable[[], bool],
    timeout: float = 60.0,
    interval: float = 0.002,
) -> bool:
    """Poll ``pred`` on the wall clock until it is truthy or ``timeout``.

    Returns the final truth of ``pred`` — callers must ``assert`` it, so a
    timeout fails loudly at the call site instead of silently falling
    through to a confusing downstream assertion.  This is the shared
    replacement for the hand-rolled deadline/sleep loops in the
    concurrency tests (``tests/test_snapshot_reads.py`` and friends).
    """
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() >= deadline:
            return bool(pred())
        time.sleep(interval)
    return True
