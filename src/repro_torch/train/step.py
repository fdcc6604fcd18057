"""Train-step builders: the plain step and the compressed data-parallel step.

``make_train_step`` differentiates ``loss_fn(params, batch, cfg)`` with
autograd and applies AdamW.  Microbatch gradient accumulation is a loop
that sums the microbatches' gradients (the reference's ``lax.scan``); a
sharded loss (``two_tower.loss_sharded``) runs through it unchanged on every
rank, since its collectives already give each rank the global gradient.
The reference's ``jit`` and ``donate`` have no counterpart: PyTorch runs
eagerly, and the update writes into the state's tensors.

``make_sharded_train_step`` is the step on a mesh with the TP/EP rules of
``distributed.sharding``: the reference's ``jax.jit(make_train_step(...,
jit=False), in_shardings=(state_sh, batch_sh))``.

``make_compressed_dp_step`` is the explicit-collective variant: pure DP over
one axis of the mesh with the int8 error-feedback gradient sum
(``optim/grad_compress.py``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import (
    tree_flatten, tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten,
)

from repro_torch.distributed.collectives import all_gather, grad_psum, pmean
from repro_torch.distributed.context import data_group, get_mesh
from repro_torch.distributed.mesh import axes_group, dp_axes_of
from repro_torch.distributed.sharding import expert_stack, sharded_dims
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


def _accumulated(grads_of: Callable, params, batch, accum: int):
    """(loss, gradients) of one batch, or averaged over the ``accum``
    microbatches of a batch with a leading accum dim."""
    if accum == 1:
        return grads_of(params, batch)
    gsum, loss_sum = None, 0.0
    for i in range(accum):
        loss, g = grads_of(params, tree_map(lambda x: x[i], batch))
        gsum = g if gsum is None else tree_map(torch.Tensor.add_, gsum, g)
        loss_sum = loss_sum + loss
    return loss_sum / accum, tree_map(lambda g: g / accum, gsum)


def _updated(state: TrainState, loss, grads, schedule: dict, weight_decay: float,
             gnorm=None):
    lr = cosine_schedule(state.step, **schedule)
    params, opt, gnorm = adamw_update(
        state.params, grads, state.opt, lr, weight_decay=weight_decay, gnorm=gnorm
    )
    new_state = TrainState(params=params, opt=opt, step=state.step + 1)
    return new_state, {"loss": loss, "gnorm": gnorm, "lr": lr}


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
    schedule = dict(peak_lr=peak_lr, warmup_steps=warmup_steps, total_steps=total_steps)

    def grads_of(params, batch):
        return value_and_grad(loss_fn, params, batch, cfg, **loss_kwargs)

    def step(state: TrainState, batch):
        loss, grads = _accumulated(grads_of, state.params, batch, accum)
        return _updated(state, loss, grads, schedule, weight_decay)

    return step


def sharded_value_and_grad(loss_fn: Callable, params, batch, cfg, mesh, shardings,
                           local: Callable, **loss_kwargs):
    """(loss, gradient blocks) of ``loss_fn`` over the mesh.

    ``params`` are this rank's blocks (``distributed.place``), ``shardings``
    their tree of ``Sharding``s, ``batch`` this rank's data block.  A leaf
    sharded over some axes is all-gathered at use, unless ``local(path,
    leaf)`` says the loss takes the block itself; the gather's transpose
    hands each rank the gradient of its own slice.  Every leaf is replicated
    over the DP axes, whose ranks see other rows: its gradient is summed
    over them (``grad_psum``).  The loss is ``pmean``-ed over the DP axes:
    each rank's ``loss_fn`` is the mean over its own rows, and the blocks
    are the same size."""
    dp_group = axes_group(mesh, dp_axes_of(mesh))
    flat, spec = tree_flatten_with_path(params)
    live = [p.detach().requires_grad_(True) for _, p in flat]
    with torch.enable_grad(), data_group(dp_group):
        used = []
        for (path, _), t, sh in zip(flat, live, tree_leaves(shardings)):
            u = grad_psum(t, dp_group)
            if not local(path, t):
                for dim, axes in sharded_dims(sh):
                    u = all_gather(u, axes_group(mesh, axes), dim)
            used.append(u)
        loss = pmean(loss_fn(tree_unflatten(used, spec), batch, cfg, **loss_kwargs),
                     dp_group)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return loss.detach(), tree_unflatten(grads, spec)


def sharded_global_norm(grads, shardings, mesh) -> torch.Tensor:
    """The global norm of the whole gradients from their blocks: each
    sharded leaf's sum of squares summed over the axes it is sharded on."""
    sums: dict[tuple, torch.Tensor] = {}
    for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)):
        axes = tuple(a for _, dim_axes in sharded_dims(sh) for a in dim_axes)
        sq = torch.sum(torch.square(g.to(torch.float32)))
        sums[axes] = sums[axes] + sq if axes in sums else sq
    total = 0.0
    for axes, sq in sums.items():
        if axes:
            dist.all_reduce(sq, group=axes_group(mesh, axes))
        total = total + sq
    return torch.sqrt(total)


def ep_local(path, leaf) -> bool:
    """Under ``mesh_context`` the expert stacks stay this rank's blocks and
    go through the expert-parallel MoE; everything else is gathered."""
    return get_mesh() is not None and expert_stack(path, leaf)


def make_sharded_train_step(
    loss_fn: Callable,
    cfg,
    mesh,
    shardings,
    *,
    local: Callable = ep_local,
    accum: int = 1,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    **loss_kwargs,
):
    """The step on a mesh: the port's ``jax.jit(make_train_step(loss_fn, cfg,
    jit=False), in_shardings=(state_sh, batch_sh))``, the reference's
    sharded step (``configs/registry.py``'s train cells).

    Returns ``step(state, batch) → (state, metrics)``.  ``state`` holds this
    rank's blocks of the params and of AdamW's moments
    (``distributed.place(state, param_sharding(state, mesh))``), ``batch``
    this rank's DP block (``place(batch, batch_sharding(batch, mesh))``; with
    ``accum > 1`` the DP block of dim 1).  ``shardings`` are the params'
    ``Sharding``s.  Gradients and the loss are those of the whole batch
    (``sharded_value_and_grad``); clipping reads the global norm; AdamW
    updates the blocks.  Without ``mesh_context`` an MoE runs the dense
    dispatch on gathered expert stacks with the whole batch's aux (GSPMD's
    semantics); under it, the stacks stay local (``local``) and go through
    the expert-parallel form."""
    schedule = dict(peak_lr=peak_lr, warmup_steps=warmup_steps, total_steps=total_steps)

    def grads_of(params, batch):
        return sharded_value_and_grad(loss_fn, params, batch, cfg, mesh, shardings, local,
                                      **loss_kwargs)

    def step(state: TrainState, batch):
        loss, grads = _accumulated(grads_of, state.params, batch, accum)
        gnorm = sharded_global_norm(grads, shardings, mesh)
        return _updated(state, loss, grads, schedule, weight_decay, gnorm)

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
