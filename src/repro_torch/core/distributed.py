"""Distributed PBME: the paper's zero-coordination row partitioning on a process grid.

RecStep partitions bit-matrix rows round-robin across CPU threads with "no or
nearly no coordination" (§5.3).  The multi-device analogue is a 2-D
SUMMA-style decomposition over a mesh of ranks (``repro_torch.distributed``):

  * Δ and M row-sharded over the data-parallel axes (``pod``, ``data``) —
    each rank owns a row block, exactly the paper's partitioning;
  * Arc column-sharded over ``model`` — the closure's columns spread across
    the tensor axis;
  * one iteration = **one all-gather of Δ along ``model``** (rebuild full Δ
    rows) + a purely local boolean product on the ``bitmm`` kernel + local
    andnot/or epilogue + a summed popcount for the termination test.

Every rank runs the same step on its own blocks; each step function records
the bytes of its collectives' outputs on this rank in its last iteration
(``step.collective_bytes``, by kind), computed from the tensors' sizes.
``tc_fixpoint_sharded.last_collective_bytes`` keeps its last step's record,
as the kernels' wrappers keep their launch counts.  ``lower_tc_step`` gives
one step and this rank's arguments as fake tensors, the counterpart of the
reference's AOT lowering: ``distributed.collective_bytes`` counts its
traffic as the reference counts XLA's HLO.  Counts are reduced as int64
(gloo has no unsigned sum, and n² bits overflow int32 past n = 46341); packed
words stay ``int32``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.bitmatrix import edges_to_bitmatrix, popcount
from repro_torch.distributed.mesh import axes_group, axis_size, mesh_device, shard_rows
from repro_torch.kernels.bitmm import bitmm
from repro_torch.kernels.ref import pack_bits, unpack_bits

SCHEDULES = ("allgather", "rows1d", "psum")


def padded_n(n: int, row_shards: int, col_shards: int) -> int:
    """Pad the domain so row blocks tile by 128 and col blocks by 128 bits."""
    row_q = 128 * row_shards
    col_q = 128 * col_shards
    q = max(row_q, col_q)
    # lcm(row_q, col_q) both powers-of-two multiples of 128 → max works
    return ((n + q - 1) // q) * q


def _count(d_new: torch.Tensor, group) -> torch.Tensor:
    cnt = popcount(d_new)
    dist.all_reduce(cnt, group=group)
    return cnt


def _gather_words(x: torch.Tensor, group, parts: int) -> torch.Tensor:
    """``[rows, w_loc]`` blocks of ``parts`` ranks side by side → ``[rows, parts·w_loc]``."""
    out = x.new_empty((parts * x.shape[0], x.shape[1]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view(parts, x.shape[0], x.shape[1]).permute(1, 0, 2).reshape(x.shape[0], -1)


def make_tc_step(mesh, row_axes: tuple[str, ...], col_axis: str):
    """The sharded PBME-TC iteration for ``mesh``.

    State on each rank: delta, m — int32[n/rows, n/32/cols], its block of
    P(row_axes, col_axis); arc — int32[n, n/32/cols], its block of
    P(None, col_axis).  Returns (delta', m', popcount(delta') over the mesh).
    """
    cols = axis_size(mesh, col_axis)
    col_group = axes_group(mesh, col_axis)
    cnt_group = axes_group(mesh, tuple(row_axes) + (col_axis,))

    def step(delta, arc, m):
        # rebuild full Δ rows: the single collective of the iteration
        delta_full = _gather_words(delta, col_group, cols)
        new = bitmm(delta_full, arc)
        d_new = new & ~m
        m_new = m | d_new
        step.collective_bytes = {"all_gather": delta_full.numel() * 4, "all_reduce": 8}
        return d_new, m_new, _count(d_new, cnt_group)

    step.collective_bytes = {}
    return step


def make_tc_step_1d(mesh, row_axes: tuple[str, ...]):
    """PAPER-FAITHFUL schedule: pure row partitioning, Arc replicated.

    This is the direct translation of PBME's zero-coordination thread
    model (§5.3): every rank owns a row block of M/Δ and the WHOLE Arc, so
    one iteration needs NO collectives at all (only the popcount sum for
    termination).  The cost is Arc replication: n²/8 bytes per rank."""
    group = axes_group(mesh, row_axes)

    def step(delta, arc, m):
        new = bitmm(delta, arc)
        d_new = new & ~m
        m_new = m | d_new
        step.collective_bytes = {"all_reduce": 8}
        return d_new, m_new, _count(d_new, group)

    step.collective_bytes = {}
    return step


def make_tc_step_psum(mesh, row_axes: tuple[str, ...], col_axis: str):
    """Alternative 2-D schedule: contraction-dim sharding + reduce-scatter.

    Δ sharded (rows × k-cols), Arc sharded (k-rows × none): each rank
    computes a PARTIAL product over its k-slice, then a reduce-scatter
    (boolean OR ≡ a sum of counts > 0) assembles and re-shards New over
    columns.  Collective moves New (counts) instead of Δ (bits) — wins when
    the frontier Δ is dense and New is small, loses otherwise.  The product
    of the unpacked {0, 1} float32 operands is a plain ``torch.matmul``, as
    the reference leaves it to XLA; its counts are exact in float32."""
    cols = axis_size(mesh, col_axis)
    col_group = axes_group(mesh, col_axis)
    cnt_group = axes_group(mesh, tuple(row_axes) + (col_axis,))

    def step(delta, arc, m):
        # partial boolean matmul over the local k-slice (counts in f32)
        a = unpack_bits(delta).to(torch.float32)
        b = unpack_bits(arc).to(torch.float32)
        partial = a @ b                                     # [rows_loc, n]
        rows, n = partial.shape
        summed = partial.new_empty((rows, n // cols))
        dist.reduce_scatter_tensor(
            summed, partial.view(rows, cols, n // cols).transpose(0, 1).reshape(-1, n // cols),
            group=col_group,
        )
        new = pack_bits(summed > 0)
        d_new = new & ~m
        m_new = m | d_new
        step.collective_bytes = {"reduce_scatter": summed.numel() * 4, "all_reduce": 8}
        return d_new, m_new, _count(d_new, cnt_group)

    step.collective_bytes = {}
    return step


def lower_tc_step(
    mesh,
    n: int,
    row_axes=("data",),
    col_axis="model",
    schedule: str = "allgather",
):
    """The sharded TC step and this rank's arguments as fake tensors (shapes
    only, on the mesh's device): the reference's AOT lowering, for the dry
    run (``launch/dryrun.py``) and the step's collective bytes.  Call the
    step under the arguments' ``FakeTensorMode`` (``args[0].fake_mode``).

    schedule ∈ {"allgather" (2-D baseline), "rows1d" (paper-faithful),
    "psum" (reduce-scatter variant)}.  Returns (step, (delta, arc, m))."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if schedule not in SCHEDULES:
        raise ValueError(f"lower_tc_step: schedule {schedule!r}, not one of {SCHEDULES}")
    row_axes = tuple(row_axes)
    rows, cols = axis_size(mesh, row_axes), axis_size(mesh, col_axis)
    n_pad = padded_n(n, rows, cols)
    w = n_pad // 32
    if schedule == "rows1d":
        step = make_tc_step_1d(mesh, row_axes)
        dm, arc = (n_pad // rows, w), (n_pad, w)
    elif schedule == "psum":
        step = make_tc_step_psum(mesh, row_axes, col_axis)
        dm, arc = (n_pad // rows, w // cols), (n_pad // cols, w)
    else:
        step = make_tc_step(mesh, row_axes, col_axis)
        dm, arc = (n_pad // rows, w // cols), (n_pad, w // cols)
    with FakeTensorMode():
        args = tuple(torch.empty(shape, dtype=torch.int32, device=mesh_device(mesh))
                     for shape in (dm, arc, dm))
    return step, args


def tc_fixpoint_sharded(
    edges,
    n: int,
    mesh,
    row_axes: tuple[str, ...] = ("data",),
    col_axis: str = "model",
    max_iters: int = 10_000,
    schedule: str = "allgather",
):
    """Distributed transitive closure: (this rank's block of M, n_pad, iterations).

    ``schedule`` ∈ {"allgather" (2-D baseline), "rows1d" (paper-faithful),
    "psum" (reduce-scatter variant)}; ``assemble_bitmatrix`` puts the blocks
    together.  ``edges`` int32[m, 2] (numpy or a tensor); every rank passes
    the same."""
    if schedule not in SCHEDULES:
        raise ValueError(f"tc_fixpoint_sharded: schedule {schedule!r}, not one of {SCHEDULES}")
    row_axes = tuple(row_axes)
    row_shards = axis_size(mesh, row_axes)
    col_shards = axis_size(mesh, col_axis)
    n_pad = padded_n(n, row_shards, col_shards)
    if not isinstance(edges, torch.Tensor):
        edges = np.asarray(edges, np.int32)
    edges = torch.as_tensor(edges, device=mesh_device(mesh))
    arc_full = edges_to_bitmatrix(edges, n_pad)
    rows = shard_rows(arc_full, mesh, row_axes)

    if schedule == "rows1d":
        arc, dm = arc_full, rows.contiguous()
        step = make_tc_step_1d(mesh, row_axes)
    else:
        dm = shard_rows(rows, mesh, col_axis, dim=1).contiguous()
        if schedule == "psum":
            arc = shard_rows(arc_full, mesh, col_axis).contiguous()      # Arc k-rows sharded
            step = make_tc_step_psum(mesh, row_axes, col_axis)
        else:
            arc = shard_rows(arc_full, mesh, col_axis, dim=1).contiguous()
            step = make_tc_step(mesh, row_axes, col_axis)
    del arc_full, rows

    delta = m = dm
    iters = 0
    while iters < max_iters:
        delta, m, cnt = step(delta, arc, m)
        iters += 1
        if int(cnt) == 0:
            break
    tc_fixpoint_sharded.last_collective_bytes = step.collective_bytes
    return m, n_pad, iters


tc_fixpoint_sharded.last_collective_bytes = {}


def assemble_bitmatrix(
    block: torch.Tensor, mesh, row_axes: tuple[str, ...] = ("data",),
    col_axis: str | None = "model",
) -> torch.Tensor:
    """Every rank's block of a packed matrix put together, on every rank:
    all-gathers over ``col_axis`` (words; None for the rows1d schedule's
    full-width blocks), then over ``row_axes`` (rows)."""
    if col_axis is not None:
        block = _gather_words(block, axes_group(mesh, col_axis), axis_size(mesh, col_axis))
    out = block.new_empty((axis_size(mesh, row_axes) * block.shape[0], block.shape[1]))
    dist.all_gather_into_tensor(out, block.contiguous(), group=axes_group(mesh, row_axes))
    return out
