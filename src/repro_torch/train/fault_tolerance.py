"""Fault tolerance: restart-from-checkpoint loop + straggler monitoring.

* :func:`run_resilient` — drives training through failures: an exception
  (preemption, a lost node) is caught, the latest checkpoint restored (onto
  ``device``, where the restarted job runs) and the loop resumed from the
  checkpointed step; the deterministic cursor-based data pipeline
  guarantees no sample loss/duplication.  A CUDA error is re-raised, not
  retried: after one the context is unusable, and a restart would turn a
  device fault into silent retries (as the serving layer's WAL replay
  re-raises device faults, ROADMAP §C).
* :class:`StragglerMonitor` — step-time watchdog; a step slower than
  ``threshold ×`` the moving median flags a straggler event and calls the
  optional hook (which may raise to trigger the resilient restart path).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.train.checkpoint import CheckpointManager


def is_device_fault(exc: BaseException) -> bool:
    """A fault of the card or of its collectives: ``torch.AcceleratorError``
    (a launch failure, an illegal access), ``torch.OutOfMemoryError``,
    ``torch.distributed.DistBackendError`` (NCCL), or a ``RuntimeError``
    carrying CUDA's own error text (``CUDA error: ...``, or the kernels'
    ``... launch failed: cudaError <n>``).  A host-side error that merely
    mentions CUDA (a tensor on the wrong device) is not one."""
    if isinstance(exc, (torch.AcceleratorError, torch.OutOfMemoryError,
                        torch.distributed.DistBackendError)):
        return True
    return isinstance(exc, RuntimeError) and any(
        mark in str(exc) for mark in ("CUDA error", "cudaError"))


@dataclass
class StragglerMonitor:
    threshold: float = 3.0
    window: int = 32
    times: list[float] = field(default_factory=list)
    events: list[tuple[int, float, float]] = field(default_factory=list)
    on_straggler: Callable | None = None

    def observe(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        is_straggler = len(self.times) >= 8 and seconds > self.threshold * med
        if is_straggler:
            self.events.append((step, seconds, med))
            if self.on_straggler is not None:
                self.on_straggler(step, seconds, med)
        return is_straggler


def run_resilient(
    *,
    init_state_fn: Callable[[], object],
    step_fn: Callable,
    data_fn: Callable[[int], dict],
    manager: CheckpointManager,
    total_steps: int,
    max_restarts: int = 3,
    device=None,
    monitor: StragglerMonitor | None = None,
    inject_failure_at: int | None = None,
):
    """Run ``total_steps`` of training surviving failures via checkpoints.

    ``inject_failure_at`` deliberately raises once at that step (test hook).
    Returns (final_state, metrics_history, n_restarts).
    """
    restarts = 0
    injected = False
    history = []

    while True:
        state = init_state_fn()
        restored = manager.restore_latest(state, device)
        start = 0
        if restored is not None:
            state, ck_step = restored
            start = ck_step if ck_step is not None else 0
        try:
            step = start
            while step < total_steps:
                t0 = time.perf_counter()
                if (
                    inject_failure_at is not None
                    and not injected
                    and step == inject_failure_at
                ):
                    injected = True
                    raise RuntimeError(f"injected node failure at step {step}")
                batch = data_fn(step)
                state, metrics = step_fn(state, batch)
                dt = time.perf_counter() - t0
                if monitor is not None:
                    monitor.observe(step, dt)
                history.append({k: float(v) for k, v in metrics.items()})
                step += 1
                manager.maybe_save(step, state)
            manager.save(total_steps, state)
            manager.wait()
            return state, history, restarts
        except Exception as exc:
            if is_device_fault(exc):
                manager.wait()
                raise
            restarts += 1
            if restarts > max_restarts:
                raise
            manager.wait()
