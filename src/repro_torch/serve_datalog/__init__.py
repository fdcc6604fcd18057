"""Incremental Datalog serving on PyTorch: transactions, DRed, MVCC reads,
the batching server.

A port of ``repro.serve_datalog`` (see its docstring for the architecture):

1. :class:`~repro_torch.serve_datalog.instance.MaterializedInstance` keeps
   the stratification plus fixpointed relations on the device and accepts
   write transactions (``apply_txn``) that commit as exactly one epoch,
   with one Δ/∇ propagation pass over the stratification: ingest variants
   and the resumable semi-naïve loop for inserts, DRed for retractions,
   recompute where monotonicity is lost, and PBME strata kept resident as
   packed bit matrices whose increments run the hand-written ``bitmm``
   kernel at row-compacted shapes.
2. State is versioned (:class:`~repro_torch.core.versioned_store.
   VersionedStore`): readers pin a published epoch and never see a
   half-applied transaction; on CUDA the writer runs on its own stream and
   each epoch carries an event that readers wait on, on the card.
3. :class:`~repro_torch.serve_datalog.plan_cache.PlanCache` memoizes parsed
   programs and stratifications by fingerprint (equal to the reference's).
4. :class:`~repro_torch.serve_datalog.server.DatalogServer` fronts an
   instance with a request queue, admission batching, group commit of
   compatible transactions on a single writer thread, snapshot reads,
   deadlines, overload policy, retries, metrics and profiles.

5. Durability (``repro_torch.persist``, the reference's on-disk formats):
   ``DatalogServer(durability=...)`` logs every transaction to a delta WAL
   before its epoch publishes and checkpoints off a reader pin on a
   background thread; ``MaterializedInstance.restore(path)`` loads the
   newest valid snapshot onto the device (packed PBME matrices included)
   and replays the WAL tail, bit for bit the pre-crash fixpoint.
6. Admission and demand: every program is admitted through the static
   analyzer's rewrites (``repro_torch.analysis``), so plan fingerprints
   equal the reference's; ``DatalogServer.lint`` and ``explain(adorn=...)``
   run the analyzer, and ``submit_query(..., on_demand=True)`` answers bound
   queries from a magic-set specialized instance on the same device.

Everything runs on CUDA unless given ``device="cpu"``::

    from repro_torch.serve_datalog import MaterializedInstance, DatalogServer
    inst = MaterializedInstance(program_text, {"arc": edges})     # CUDA
    inst.apply_txn([("insert", "arc", new_edges)])
    inst.query("tc", src=3)
"""

from repro_torch.analysis.demand import DemandConfig, DemandTransform
from repro_torch.core.versioned_store import Snapshot, VersionedStore
from repro_torch.obs.explain import PlanEstimate
from repro_torch.obs.profile import FixpointProfile
from repro_torch.persist.manager import DurabilityConfig, DurabilityManager
from repro_torch.serve_datalog.instance import (
    MaterializedInstance,
    OpStats,
    TxnOp,
    UpdateStats,
)
from repro_torch.serve_datalog.plan_cache import CompiledPlan, PlanCache, default_cache
from repro_torch.serve_datalog.server import (
    DatalogServer,
    DeadlineError,
    OverloadError,
    RequestError,
    ServerLimits,
    ServerStats,
    ServerTransaction,
)

__all__ = [
    "MaterializedInstance",
    "TxnOp",
    "OpStats",
    "UpdateStats",
    "CompiledPlan",
    "PlanCache",
    "default_cache",
    "DatalogServer",
    "ServerTransaction",
    "ServerLimits",
    "RequestError",
    "OverloadError",
    "DeadlineError",
    "ServerStats",
    "Snapshot",
    "VersionedStore",
    "DurabilityConfig",
    "DurabilityManager",
    "PlanEstimate",
    "FixpointProfile",
    "DemandConfig",
    "DemandTransform",
]
