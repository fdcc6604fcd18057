"""Deterministic load generation + scenario harness for ``DatalogServer``.

The port of ``repro.loadgen`` onto ``repro_torch``: the same seeded traces,
virtual clock and verdicts; the workloads build the port's instances on
their ``device`` (CUDA unless ``device="cpu"``).

The hostile-traffic half of the serving story: RecStep's claim (PAPER.md) is
that one general-purpose engine holds up across *dissimilar* workloads, and
a server only earns that claim under dissimilar **traffic** — bursty
arrivals, hot-key transaction storms, mixed txn/query ratios — not just the
polite uniform batches benchmarks send.  FlowLog (PAPERS.md) shows
incremental operators pay off exactly when update batches stay small and
steady, which is the property adversarial arrival patterns destroy; this
package generates those patterns reproducibly and measures what the
admission-control layer (:class:`~repro_torch.serve_datalog.limits.ServerLimits`)
does about them.

Three modules:

* :mod:`repro_torch.loadgen.clock` — :class:`VirtualClock` (a manually advanced
  monotonic clock the server can run on, making admission/shedding/deadline
  decisions bit-for-bit reproducible in CI) and :func:`wait_until` (the
  polling helper timing-sensitive tests use instead of wall-clock sleeps).
* :mod:`repro_torch.loadgen.arrivals` — seeded arrival-trace generators: Poisson
  steady-state, bursty on/off, adversarial hot-key txn storms, mixed
  txn/query ratios, and CSDA program-analysis replay.  A trace is a plain
  ``list[Arrival]`` fully determined by its seed.
* :mod:`repro_torch.loadgen.scenario` — the driver: replays a trace against a
  ``DatalogServer`` on a virtual clock, interleaving submissions with
  admission steps, and returns a :class:`ScenarioResult` with per-kind
  latency percentiles (measured on the *wall* clock — the perf signal),
  shed/deadline-miss counts (decided on the *virtual* clock — the
  deterministic signal), and an exactness verdict: the final fixpoint must
  be bit-for-bit a serial replay of exactly the accepted transactions.

The per-scenario delta/latency statistics are the ground truth a later
adaptive-policy layer ("Adaptive Recursive Query Optimization", PAPERS.md)
trains against.
"""

from repro_torch.loadgen.arrivals import (
    Arrival,
    bursty_times,
    csda_replay_arrivals,
    hotkey_storm_arrivals,
    mixed_arrivals,
    poisson_times,
)
from repro_torch.loadgen.clock import VirtualClock, sleep_on, wait_until
from repro_torch.loadgen.scenario import (
    CsdaWorkload,
    Scenario,
    ScenarioResult,
    TcWorkload,
    check_exactness,
    run_scenario,
)

__all__ = [
    "Arrival",
    "VirtualClock",
    "sleep_on",
    "wait_until",
    "poisson_times",
    "bursty_times",
    "mixed_arrivals",
    "hotkey_storm_arrivals",
    "csda_replay_arrivals",
    "Scenario",
    "ScenarioResult",
    "TcWorkload",
    "CsdaWorkload",
    "check_exactness",
    "run_scenario",
]
