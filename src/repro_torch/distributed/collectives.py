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
* ``pmean``: ``psum`` over the group's size, backward the cotangent over
  that size;
* ``all_gather``: all-gather along a dimension; backward this rank's slice;
* ``grad_psum``: the identity forward; backward an all-reduce — the sum
  over the ranks that hold a replicated parameter but see other rows of
  the batch, which GSPMD inserts for the reference;
* ``ppermute``: each rank's tensor sent along a permutation of the group's
  ranks; backward the cotangent sent along the inverse permutation.

Tensors go to the collectives contiguous; outputs are allocated here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gathered(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``, contiguous (a gathered
    weight then meets the same products as the whole one)."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.movedim(0, dim).contiguous()


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
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.rows = dim, x.shape[dim]
        ctx.index = dist.get_group_rank(group, dist.get_rank())
        return _gathered(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows), None, None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def _permuted(x: torch.Tensor, group, perm, tag: int) -> torch.Tensor:
    """Send ``x`` to the rank that ``perm`` maps this one to and receive from
    the rank that maps to this one (group ranks; a rank that receives from
    nobody gets zeros, as JAX's ``ppermute`` gives it).  A pair that maps a
    rank to itself is a local copy: nothing is sent to self."""
    me = dist.get_group_rank(group, dist.get_rank())
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if dst and dst[0] != me:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst[0]), group,
                              tag))
    if src and src[0] == me:
        out.copy_(x)
    elif src:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src[0]), group,
                              tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm, tag):
        ctx.group, ctx.tag = group, tag
        ctx.inverse = [(d, s) for s, d in perm]
        return _permuted(x, group, perm, tag)

    @staticmethod
    def backward(ctx, g):
        return _permuted(g, ctx.group, ctx.inverse, ctx.tag), None, None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, replicated on every rank."""
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over ``group``, replicated on every rank."""
    return _Psum.apply(x, group) / dist.get_world_size(group)


def ppermute(x: torch.Tensor, group, perm, tag: int = 0) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` is a list of (source, destination)
    group ranks; this rank gets the ``x`` of the rank that maps to it.
    ``tag`` tells apart the messages of exchanges that run back to back
    between the same two ranks."""
    return _Ppermute.apply(x, group, [tuple(p) for p in perm], tag)


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; rank r keeps rows block r of dim 0 (``tiled``)."""
    return _PsumScatter.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    return _AllGather.apply(x, group, dim)


def grad_psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient summed over ``group``."""
    return _GradPsum.apply(x, group)
