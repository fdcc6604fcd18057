"""AdamW with decoupled weight decay and global-norm clipping, on trees of
tensors (nested dicts, lists, tuples).  The state is the reference's
``{mu, nu, count}``, moments in float32 whatever the parameters' type, so
optimizer state crosses between the packages (``interop``, checkpoints).
The update is the reference's, in float32: clip to the global norm first,
``b2 = 0.95``, ``eps`` outside ``sqrt(nu / bc2)``, the decay added to the
step of every leaf.

The reference's arrays are immutable; here ``adamw_update`` writes the new
values into the parameters', ``mu``'s and ``nu``'s own tensors (one copy of
a multi-gigabyte table, not two) and returns them, with the bias
corrections folded into scalars so that a leaf's update runs in place with
one temporary of its size.
"""

from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def adamw_init(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def clip_by_global_norm(grads, max_norm: float, gnorm=None):
    """``grads`` scaled to a global norm of at most ``max_norm``; ``gnorm``,
    when given, is that norm (a sharded step computes it over its ranks)."""
    if gnorm is None:
        leaves = tree_leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def adamw_update(
    params,
    grads,
    state,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    gnorm=None,
):
    """One step: (params, new state, the global norm before clipping).
    ``params``, ``mu`` and ``nu`` are updated in place; ``lr`` is a number
    or a 0-d tensor (``cosine_schedule``), read once with the count.
    ``gnorm``: the gradients' global norm where ``grads`` are blocks of
    sharded leaves (``train.step.make_sharded_train_step``)."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, gnorm)
    count = state["count"] + 1
    # the bias corrections and the learning rate as numbers (one read of the
    # count), so each leaf's update is in-place arithmetic with one temporary:
    # p ← p·(1 − lr·wd) − (lr·√bc2 / bc1) · mu / (√nu + eps·√bc2), which is
    # the reference's p − lr·((mu/bc1) / (√(nu/bc2) + eps) + wd·p)
    if is_fake(count):
        # a shapes-only trace (launch/dryrun.py) has no count or rate to read
        t, lr = 1, 0.0
    else:
        t, lr = int(count), float(lr)
    bc1, sqrt_bc2 = 1.0 - b1 ** t, math.sqrt(1.0 - b2 ** t)

    with torch.no_grad():
        flat_p, spec = tree_flatten(params)
        for p, g, mu, nu in zip(flat_p, tree_leaves(grads), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            g32 = g.to(torch.float32)
            mu.lerp_(g32, 1 - b1)
            nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            del g32
            denom = nu.sqrt().add_(eps * sqrt_bc2)
            p32 = p if p.dtype == torch.float32 else p.to(torch.float32)
            p32.mul_(1 - lr * weight_decay).addcdiv_(mu, denom, value=-lr * sqrt_bc2 / bc1)
            del denom
            if p32 is not p:
                p.copy_(p32)
    new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return tree_unflatten(flat_p, spec), new_state, gnorm
