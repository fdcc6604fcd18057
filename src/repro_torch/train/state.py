"""Train state: params + AdamW moments + step, as a plain tree of tensors."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.optim.adamw import adamw_init


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor       # int32 scalar


def init_train_state(params) -> TrainState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))
