"""ServerLimits: admission control, backpressure, deadlines, retry policy.

The knobs that turn :class:`~repro_torch.serve_datalog.server.DatalogServer` from
"a queue that grows until the process dies" into a server that holds a
latency contract under hostile traffic:

* **Bounded queue** (``max_queue_depth``) with an explicit overload policy:
  ``reject`` sheds the request at submission with
  :class:`~repro_torch.serve_datalog.errors.OverloadError`; ``block`` applies
  backpressure — the submitter cooperatively drains admission groups
  (serving the server's own queue) until there is room, so a fast producer
  pays for the backlog it created instead of growing it.
* **Graceful degradation** (``degrade_at``): above this fraction of the
  queue bound, *query* submissions shed first while updates are still
  admitted up to the full bound — under overload the system of record keeps
  accepting writes and sacrifices read traffic, which a client can retry
  against a replica or a stale cache.
* **Deadlines** (``default_deadline`` + per-request ``deadline=``): a
  request past its deadline is failed cheaply without evaluation — at
  submission (raised), at admission (delivered, *before* the WAL sees it),
  or between strata of an in-flight propagation pass (the transaction
  aborts and publishes nothing).
* **Writer retry** (``max_retries``/``retry_jitter``/``writer_timeout``):
  when a coalesced group falls back to per-request application, transient
  failures retry with seeded jittered backoff inside the writer-lane
  timeout budget instead of bouncing straight to the client.

``DatalogServer(limits=None)`` (the default) is bit-for-bit the historical
unbounded behavior; every limit is opt-in and enforced outside the
evaluation hot path.  All times are seconds on the server's clock
(``DatalogServer(clock=...)`` — a virtual clock with ``now()`` and
``sleep()`` makes scenario replays deterministic).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ServerLimits:
    """Admission-control and robustness knobs for one ``DatalogServer``.

    Attributes
    ----------
    max_queue_depth:
        Requests admitted to the queue at once; ``None`` = unbounded (the
        historical behavior).  Enforced at submission time.
    overload_policy:
        ``"reject"`` — a submission over the bound raises
        :class:`~repro_torch.serve_datalog.errors.OverloadError`;
        ``"block"`` — the submitter drains admission groups until there is
        room (cooperative backpressure; deterministic, no busy-wait).
    degrade_at:
        Fraction of ``max_queue_depth`` above which *query* submissions are
        shed while updates still fill the remaining headroom.  ``1.0``
        disables early shedding (queries and updates shed together at the
        bound).
    default_deadline:
        Seconds-from-submission applied to every request that does not pass
        its own ``deadline=``; ``None`` = no implicit deadline.
    writer_timeout:
        Retry budget (seconds) for per-request fallback retries after a
        coalesced group fails; retries stop once exceeded.  ``None`` with
        ``max_retries > 0`` means the retry count alone bounds the loop.
    max_retries:
        Extra attempts for a failed per-request fallback application
        (transient-failure absorption).  ``0`` = fail straight through.
    retry_jitter:
        Upper bound (seconds) of the uniform jitter slept between retries,
        scaled by the attempt number.  Drawn from a generator seeded with
        ``retry_seed`` so retry schedules are reproducible.
    retry_seed:
        Seed for the jitter generator.
    stats_records_cap:
        Bound on ``ServerStats.records`` (per-request latency records).
        The historical default was a fixed 65536; long soaks can lower it.
    slow_query_threshold:
        Sojourn (queued + service seconds) above which a finished request's
        full profile tree is captured into the slow-query ring
        (``srv.slow_queries()``).  Setting a threshold auto-profiles every
        request (the capture needs the spans); ``None`` = off.
    slow_query_log:
        Capacity of the slow-query ring (oldest captures evicted first).
    demand_instances:
        Capacity of the server's LRU of demand-specialized instances (one
        per ``(relation, binding pattern)`` routed through
        ``submit_query(..., on_demand=True)``).  Evicted or epoch-stale
        entries respecialize on next touch; fallback decisions are cached
        too, so a pattern that cannot specialize is not re-analyzed per
        query.
    """

    max_queue_depth: int | None = None
    overload_policy: str = "reject"
    degrade_at: float = 1.0
    default_deadline: float | None = None
    writer_timeout: float | None = None
    max_retries: int = 0
    retry_jitter: float = 0.0
    retry_seed: int = 0
    stats_records_cap: int = 65536
    slow_query_threshold: float | None = None
    slow_query_log: int = 64
    demand_instances: int = 8

    def __post_init__(self) -> None:
        if self.overload_policy not in ("reject", "block"):
            raise ValueError(
                f"overload_policy must be 'reject' or 'block', "
                f"got {self.overload_policy!r}"
            )
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (or None)")
        if not (0.0 < self.degrade_at <= 1.0):
            raise ValueError("degrade_at must be in (0, 1]")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_jitter < 0:
            raise ValueError("retry_jitter must be >= 0")
        if self.stats_records_cap < 1:
            raise ValueError("stats_records_cap must be >= 1")
        if self.slow_query_threshold is not None and self.slow_query_threshold < 0:
            raise ValueError("slow_query_threshold must be >= 0 (or None)")
        if self.slow_query_log < 1:
            raise ValueError("slow_query_log must be >= 1")
        if self.demand_instances < 1:
            raise ValueError("demand_instances must be >= 1")

    @property
    def degrade_depth(self) -> int | None:
        """Queue depth at which query submissions start shedding."""
        if self.max_queue_depth is None:
            return None
        return max(1, int(self.max_queue_depth * self.degrade_at))
