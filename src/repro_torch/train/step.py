"""Train-step builders: the plain step and the compressed data-parallel step.

``make_train_step`` differentiates ``loss_fn(params, batch, cfg)`` with
autograd and applies AdamW.  Microbatch gradient accumulation is a loop
that sums the microbatches' gradients (the reference's ``lax.scan``); a
sharded loss (``two_tower.loss_sharded``) runs through it unchanged on every
rank, since its collectives already give each rank the global gradient.
The reference's ``jit`` and ``donate`` have no counterpart: PyTorch runs
eagerly, and the update writes into the state's tensors.

``make_compressed_dp_step`` is the explicit-collective variant: pure DP over
one axis of the mesh with the int8 error-feedback gradient sum
(``optim/grad_compress.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.distributed.mesh import axes_group
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.grad_compress import compressed_psum
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.state import TrainState


def value_and_grad(loss_fn: Callable, params, batch, cfg, **loss_kwargs):
    """(loss, gradient tree) of ``loss_fn(params, batch, cfg)`` at ``params``;
    the parameters' own tensors are left without ``requires_grad``."""
    flat, spec = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(live, spec), batch, cfg, **loss_kwargs)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return loss.detach(), tree_unflatten(grads, spec)


def make_train_step(
    loss_fn: Callable,
    cfg,
    *,
    accum: int = 1,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    **loss_kwargs,
):
    """Returns ``step(state, batch) → (state, metrics)``.

    With ``accum > 1`` the batch must carry a leading accum dim; gradients
    are averaged across microbatches.
    """

    def step(state: TrainState, batch):
        if accum > 1:
            gsum, loss_sum = None, 0.0
            for i in range(accum):
                mb = tree_map(lambda x: x[i], batch)
                loss, g = value_and_grad(loss_fn, state.params, mb, cfg, **loss_kwargs)
                gsum = g if gsum is None else tree_map(torch.Tensor.add_, gsum, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / accum, gsum)
            loss = loss_sum / accum
        else:
            loss, grads = value_and_grad(loss_fn, state.params, batch, cfg, **loss_kwargs)

        lr = cosine_schedule(
            state.step,
            peak_lr=peak_lr,
            warmup_steps=warmup_steps,
            total_steps=total_steps,
        )
        params, opt, gnorm = adamw_update(
            state.params, grads, state.opt, lr, weight_decay=weight_decay
        )
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return step


def make_compressed_dp_step(
    loss_fn: Callable,
    cfg,
    mesh,
    dp_axis: str = "data",
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
):
    """Pure-DP step with int8 error-feedback gradient compression.

    Returns ``step(state, err, batch) → (state, err, metrics)``.  Params are
    replicated; ``batch`` is this rank's shard of the global batch along
    dim 0 (``distributed.shard_rows(x, mesh, dp_axis)``); the gradients are
    summed over ``dp_axis``'s group with the quantization residual in this
    rank's ``err`` (``compress_state_init``), and the loss is the group's
    mean.
    """
    group = axes_group(mesh, dp_axis)
    n = dist.get_world_size(group)

    def step_fn(state: TrainState, err, batch):
        loss, grads = value_and_grad(loss_fn, state.params, batch, cfg)
        grads, err = compressed_psum(grads, err, group)
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        loss = loss / n
        lr = cosine_schedule(
            state.step, peak_lr=peak_lr, warmup_steps=warmup_steps, total_steps=total_steps
        )
        params, opt, gnorm = adamw_update(state.params, grads, state.opt, lr)
        return TrainState(params, opt, state.step + 1), err, {"loss": loss, "gnorm": gnorm}

    return step_fn
