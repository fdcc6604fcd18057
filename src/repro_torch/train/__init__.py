from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.step import (
    make_compressed_dp_step, make_sharded_train_step, make_train_step,
)
from repro_torch.train.checkpoint import CheckpointManager, save_pytree, restore_pytree
from repro_torch.train.fault_tolerance import StragglerMonitor, run_resilient

__all__ = [
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_compressed_dp_step",
    "make_sharded_train_step",
    "CheckpointManager",
    "save_pytree",
    "restore_pytree",
    "StragglerMonitor",
    "run_resilient",
]
