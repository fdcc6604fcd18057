"""Serving-layer error types.

Lives in its own module so ``plan_cache`` (admission) can raise
:class:`RequestError` without importing ``server`` (which imports
``instance``, which imports ``plan_cache`` — a cycle otherwise).
``server`` re-exports it, so ``from repro_torch.serve_datalog.server import
RequestError`` keeps working.
"""

from __future__ import annotations


class RequestError(Exception):
    """Terminal per-request failure.

    Delivered in ``done`` like a result for failures that surface at apply
    time, and *raised* at submission time by ``tx.submit()``/``submit_txn``
    for malformed transactions (which never reach the queue or the WAL —
    those carry ``rid == -1``).

    Admission failures (a program rejected by the static analyzer) carry
    the full coded diagnostic list in ``diagnostics`` — each entry is a
    ``repro_torch.analysis.Diagnostic`` with a stable ``DL...`` code and
    source span, so clients can render or match on them.
    """

    def __init__(self, rid: int, error: str, diagnostics: list | None = None):
        super().__init__(error)
        self.rid = rid
        self.error = error
        self.diagnostics: list = diagnostics or []


class OverloadError(RequestError):
    """The server shed this request instead of queueing it.

    Raised at submission time when :class:`~repro_torch.serve_datalog.limits.
    ServerLimits` bounds the queue and the ``reject`` overload policy (or
    graceful degradation, which sheds query load before update load) refuses
    admission.  The request never reaches the queue, the WAL, or the store —
    shedding is free by construction.  ``rid`` is the id the request would
    have had; it is consumed so a resubmission is distinguishable.
    Observable as ``datalog_requests_shed_total{kind=...}``.
    """


class DeadlineError(RequestError):
    """The request's deadline passed before it produced a result.

    Three stages, all carrying the request's ``rid`` (``stage`` records
    which):

    * ``submit`` — the deadline was already in the past at submission;
      raised immediately, nothing is queued.
    * ``admission`` — the deadline expired while the request waited in the
      queue; delivered through ``done`` without evaluating anything (an
      expired update is dropped *before* it is WAL-logged, so recovery can
      never replay it).
    * ``inflight`` — an update's propagation pass crossed the deadline
      between strata; the transaction aborts and publishes nothing (MVCC
      rollback), so a deadline-failed update leaves no trace.

    Observable as ``datalog_deadline_misses_total{stage=...}``.
    """

    def __init__(self, rid: int, error: str, stage: str = "admission"):
        super().__init__(rid, error)
        self.stage = stage
