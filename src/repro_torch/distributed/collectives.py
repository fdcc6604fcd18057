"""Collectives over a process group, differentiable with the reference's
transposes.

The reference differentiates through ``psum``, ``psum_scatter`` and
``all_gather`` inside ``shard_map``; its gradient of a sharded loss equals
its gradient of the unsharded loss (``tests/test_torch_distributed.py``
holds both at a (4, 2) mesh).  ``torch.distributed.nn.functional`` sums
every rank's cotangent in each backward, which is right when each rank
holds a different loss; here every rank computes the same, replicated loss,
so that sum would scale the gradient by the group's size.  These give the
transposes for a replicated result:

* ``psum``: all-reduce forward; backward the identity (each rank's cotangent
  already is the replicated one);
* ``psum_scatter``: reduce-scatter along dim 0; backward an all-gather;
* ``all_gather``: all-gather along dim 0; backward this rank's slice;
* ``grad_psum``: the identity forward; backward an all-reduce — the sum
  over the ranks that hold a replicated parameter but see other rows of
  the batch, which GSPMD inserts for the reference.

Tensors go to the collectives contiguous; outputs are allocated here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gathered(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _scattered(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows do not split over {n} ranks")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scattered(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.index = dist.get_group_rank(group, dist.get_rank())
        return _gathered(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows), None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, replicated on every rank."""
    return _Psum.apply(x, group)


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; rank r keeps rows block r of dim 0 (``tiled``)."""
    return _PsumScatter.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in group-rank order."""
    return _AllGather.apply(x, group)


def grad_psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``group``."""
    return _GradPsum.apply(x, group)
