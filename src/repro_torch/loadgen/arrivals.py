"""Seeded arrival-trace generators: the hostile-traffic pattern library.

A trace is a plain ``list[Arrival]`` sorted by arrival time, fully
determined by its seed — replaying one against a server on a
:class:`~repro_torch.loadgen.clock.VirtualClock` reproduces every admission,
shedding, and deadline decision bit-for-bit.  The generators model the
traffic shapes that defeat naive serving loops:

* :func:`poisson_times` — memoryless steady state, the polite baseline.
* :func:`bursty_times` — on/off (interrupted Poisson) arrivals: long quiet
  stretches punctuated by bursts far above the service rate, the pattern
  that makes an unbounded queue grow without bound while *average* load
  looks fine.
* :func:`hotkey_storm_arrivals` — adversarial transaction storms that
  insert and retract the *same* rows around one hot key, deliberately
  breaking group-commit compatibility so every batch pays the per-request
  fallback path.
* :func:`mixed_arrivals` — interleaved txn/query traffic at a configurable
  ratio, for testing graceful degradation (queries shed before updates).
* :func:`csda_replay_arrivals` — a steady program-analysis fact stream
  (CSDA-shaped: deep chains, many fixpoint iterations per batch), the
  workload PAPER.md's engine actually serves.

An :class:`Arrival` is workload-agnostic — time, kind, an integer key, a
size, and an optional deadline.  ``repro_torch.loadgen.scenario`` adapters turn
(kind, key, size) into concrete transactions and queries.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Arrival:
    """One request arrival in a trace.

    ``t`` is seconds since scenario start on the virtual clock; ``key``
    and ``size`` parameterize the workload adapter (which rows a txn
    touches, what a query selects); ``deadline`` is relative
    seconds-from-submission (``None`` = the scenario's default).
    """

    t: float
    kind: str                    # "query" | "txn"
    key: int = 0
    size: int = 1
    deadline: float | None = None


def poisson_times(
    rate: float, duration: float, seed: int = 0
) -> list[float]:
    """Poisson arrival times at ``rate``/sec over ``duration`` seconds."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0 (got {rate})")
    rng = random.Random(seed)
    times, t = [], 0.0
    while True:
        t += rng.expovariate(rate)
        if t >= duration:
            return times
        times.append(t)


def bursty_times(
    base_rate: float,
    burst_rate: float,
    period: float,
    duty: float,
    duration: float,
    seed: int = 0,
) -> list[float]:
    """On/off (interrupted Poisson) arrivals.

    Each ``period`` spends its first ``duty`` fraction in the *on* state
    (arrivals at ``burst_rate``) and the rest in *off* (``base_rate``;
    0 = silent).  ``bursty_times(0, 50, 1.0, 0.2, 10)`` is ten one-second
    cycles, each a 200 ms burst of ~10 arrivals then 800 ms of silence —
    mean load 10/sec, instantaneous load 50/sec.
    """
    if not (0.0 < duty < 1.0):
        raise ValueError(f"duty must be in (0, 1) (got {duty})")
    rng = random.Random(seed)
    times, t = [], 0.0
    while t < duration:
        # phase and boundary MUST come from the same cycle index: mixing
        # ``t % period`` with ``t // period`` lets float rounding disagree
        # about which side of the on/off edge ``t`` sits on (t=0.5,
        # period=0.4, duty=0.25 → phase says *on* but the on-boundary
        # computes to exactly t, and the loop never advances)
        k = int(t // period)
        on_end = k * period + period * duty
        on = t < on_end
        boundary = on_end if on else (k + 1) * period
        if boundary <= t:           # fp guard: always make progress
            t = math.nextafter(t, math.inf)
            continue
        rate = burst_rate if on else base_rate
        if rate <= 0:
            # jump to the next phase boundary — no arrivals in a silent phase
            t = boundary
            continue
        dt = rng.expovariate(rate)
        if t + dt >= boundary:
            t = boundary            # rate changes at the boundary; re-draw
            continue
        t += dt
        if t < duration:
            times.append(t)
    return times


def mixed_arrivals(
    rate: float,
    duration: float,
    query_fraction: float = 0.5,
    n_keys: int = 64,
    seed: int = 0,
    deadline: float | None = None,
    times: list[float] | None = None,
) -> list[Arrival]:
    """Interleaved txn/query traffic at ``query_fraction`` reads.

    Arrival times are Poisson at ``rate`` unless an explicit ``times``
    trace is given (so bursty or replayed time bases can carry a mixed
    kind stream).  Keys are uniform over ``n_keys``.
    """
    rng = random.Random(seed + 1)       # kinds/keys independent of times
    if times is None:
        times = poisson_times(rate, duration, seed)
    return [
        Arrival(
            t=t,
            kind="query" if rng.random() < query_fraction else "txn",
            key=rng.randrange(n_keys),
            size=1 + rng.randrange(3),
            deadline=deadline,
        )
        for t in times
    ]


def hotkey_storm_arrivals(
    rate: float,
    duration: float,
    hot_key: int = 0,
    hot_fraction: float = 0.9,
    n_keys: int = 64,
    seed: int = 0,
    deadline: float | None = None,
) -> list[Arrival]:
    """Adversarial txn storm concentrated on one hot key.

    ``hot_fraction`` of transactions target ``hot_key``; the scenario
    workload maps consecutive hot-key transactions to insert/retract pairs
    over the *same* rows, which is exactly the pattern group-commit
    admission must refuse to coalesce (a merged transaction would both
    insert and retract one row) — so the storm degenerates every batch to
    per-request application, the server's worst sustainable case.
    """
    rng = random.Random(seed + 2)
    return [
        Arrival(
            t=t,
            kind="txn",
            key=hot_key if rng.random() < hot_fraction else rng.randrange(n_keys),
            size=1,
            deadline=deadline,
        )
        for t in poisson_times(rate, duration, seed)
    ]


def csda_replay_arrivals(
    n_batches: int,
    gap: float,
    seed: int = 0,
    query_every: int = 0,
    deadline: float | None = None,
) -> list[Arrival]:
    """A steady program-analysis fact stream: one txn every ``gap`` seconds.

    Models replaying a CSDA (context-sensitive dataflow) fact feed into a
    live instance — each arrival's ``key`` is its batch index, which the
    CSDA workload adapter maps to the next slice of held-out ``arc`` facts.
    ``query_every > 0`` interleaves a point query after every N batches
    (the analysis client polling for new ``null`` derivations).  Arrival
    jitter is seeded, ±20% of ``gap``.
    """
    rng = random.Random(seed + 3)
    out: list[Arrival] = []
    for i in range(n_batches):
        t = (i + 1) * gap + rng.uniform(-0.2, 0.2) * gap
        out.append(Arrival(t=max(t, 0.0), kind="txn", key=i, deadline=deadline))
        if query_every and (i + 1) % query_every == 0:
            out.append(
                Arrival(
                    t=max(t, 0.0) + gap * 0.1, kind="query",
                    key=rng.randrange(64), deadline=deadline,
                )
            )
    out.sort(key=lambda a: a.t)
    return out
