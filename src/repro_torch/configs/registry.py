"""Cell registry: (architecture × input shape) → a step on the mesh.

Every assigned cell resolves here to a ``Cell``: the port's step (``fn``),
its arguments as tensors on the ``meta`` device (shapes and dtypes, nothing
allocated: torch's ``ShapeDtypeStruct``), their ``Sharding``s over the mesh,
and an analytic MODEL_FLOPS for the roofline's useful-compute ratio.  ``fn``
takes this rank's blocks of real arguments (``distributed.place``): a train
cell is ``train.make_sharded_train_step``; a recsys cell goes through
``loss_sharded``/``serve_scores`` on the mesh; the other steps gather what
they read at use.  The mesh may be a ``DeviceMesh`` or, to build cells
without ranks, a ``{axis: size}`` mapping (``fn`` then needs the ranks).

Shape-padding policy: logical cell shapes are the assignment's exact
numbers; edge/node counts are padded up to multiples of 512 (with -1 edge
sentinels) where DP sharding requires divisibility — logical and padded
sizes are both recorded.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._pytree import tree_map

from repro_torch.distributed.mesh import axis_sizes, dp_axes_of
from repro_torch.distributed.sharding import (
    Sharding, batch_sharding, gather, param_sharding, place,
)
from repro_torch.models.gnn.common import GNNConfig, GraphBatch
from repro_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    init_cache,
    init_params as lm_init,
    lm_loss,
    prefill,
)
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_sharded_train_step

I32, F32 = torch.int32, torch.float32
META = "meta"


def _pad_to(n: int, q: int = 512) -> int:
    return ((n + q - 1) // q) * q


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str                     # lm | gnn | recsys
    step: str                     # train | prefill | decode | serve | retrieval
    skip: str | None = None      # official skip reason (assignment rule)
    bonus: bool = False
    fn: Callable | None = None
    args: tuple = ()
    in_shardings: Any = None
    model_flops: float = 0.0     # useful FLOPs per step (6ND train / 2ND serve)
    note: str = ""


# --------------------------------------------------------------------------
# architectures
# --------------------------------------------------------------------------

LM_ARCHS = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
}
GNN_ARCHS = {
    "gcn-cora": ("repro_torch.configs.gcn_cora", "gcn"),
    "meshgraphnet": ("repro_torch.configs.meshgraphnet", "meshgraphnet"),
    "schnet": ("repro_torch.configs.schnet", "schnet"),
    "graphcast": ("repro_torch.configs.graphcast", "graphcast"),
}
RECSYS_ARCHS = {"two-tower-retrieval": "repro_torch.configs.two_tower_retrieval"}

LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
GNN_SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
RECSYS_SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

ALL_ARCHS = list(LM_ARCHS) + list(GNN_ARCHS) + list(RECSYS_ARCHS)


def arch_config(arch: str, smoke: bool = False):
    """The FULL (or, with ``smoke``, the SMOKE) configuration of ``arch``."""
    if arch in LM_ARCHS:
        mod = importlib.import_module(LM_ARCHS[arch])
    elif arch in GNN_ARCHS:
        mod = importlib.import_module(GNN_ARCHS[arch][0])
    elif arch in RECSYS_ARCHS:
        mod = importlib.import_module(RECSYS_ARCHS[arch])
    else:
        raise KeyError(f"unknown arch {arch!r}: the registry has {ALL_ARCHS}")
    return mod.SMOKE if smoke else mod.FULL


def shapes_for(arch: str) -> list[str]:
    if arch in LM_ARCHS:
        return LM_SHAPES
    if arch in GNN_ARCHS:
        return GNN_SHAPES
    return RECSYS_SHAPES


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ALL_ARCHS for s in shapes_for(a)]


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------

_LM_SHAPE_DEFS = {
    "train_4k": dict(seq=4096, batch=256, step="train"),
    "prefill_32k": dict(seq=32768, batch=32, step="prefill"),
    "decode_32k": dict(seq=32768, batch=128, step="decode"),
    "long_500k": dict(seq=524288, batch=1, step="decode"),
}


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes_of(mesh))


def _state_specs(cfg: TransformerConfig, mesh):
    state_sds = init_train_state(lm_init(cfg, device=META))
    return state_sds, param_sharding(state_sds, mesh)


def _cache_sharding(cache_sds, mesh, batch: int):
    """Cache: batch over DP (when divisible), sequence over model."""
    dp = dp_axes_of(mesh)
    dp_size = _dp_size(mesh)
    tp = axis_sizes(mesh)["model"]

    def one(leaf):
        # (L, B, S, ...) — batch over dp if divisible else None; seq over tp
        spec = [None, dp if batch % dp_size == 0 else None]
        seq = leaf.shape[2]
        spec.append("model" if seq % tp == 0 else None)
        spec += [None] * (leaf.ndim - 3)
        # long-context single-sequence: fold dp into the sequence dim too
        if batch % dp_size != 0 and seq % (tp * dp_size) == 0:
            spec[2] = tuple(dp) + ("model",)
        return Sharding(mesh, tuple(spec))

    return tree_map(one, cache_sds)


def _lm_train_flops(cfg, tokens: int) -> float:
    return 6.0 * cfg.active_param_count() * tokens


def _accum_for(cfg: TransformerConfig, batch: int, seq: int, mesh) -> int:
    """Pick grad-accum so saved layer activations stay ≲6 GB/device."""
    dp = _dp_size(mesh)
    per_dev = cfg.n_layers * (batch // dp) * seq * cfg.d_model * 2  # bf16
    accum = 1
    while per_dev / accum > 6e9 and (batch // dp) % (accum * 2) == 0:
        accum *= 2
    return accum


def build_lm_cell(arch: str, shape: str, mesh, layers: int | None = None) -> Cell:
    """``layers`` cuts the stack after the dense prefix to that many layers
    (the dry run's depth extrapolation, ``launch/dryrun.py``); the gradient
    accumulation stays the full depth's, and MODEL_FLOPS count the cut model."""
    full: TransformerConfig = arch_config(arch)
    cfg = full if layers is None else dataclasses.replace(
        full, n_layers=full.n_dense_prefix + layers)
    sd = _LM_SHAPE_DEFS[shape]
    seq, batch = sd["seq"], sd["batch"]
    dp = dp_axes_of(mesh)

    if shape == "long_500k":
        # Assignment rule: sub-quadratic attention required — all five LM
        # archs are full-attention → official skip.  The O(S)-per-token
        # decode step ships as a non-scored bonus cell.
        cell = _lm_decode_cell(arch, shape, cfg, mesh, seq, batch)
        cell.skip = "full-attention arch (long_500k requires sub-quadratic)"
        cell.bonus = True
        cell.note = "bonus: sequence-sharded split-KV decode (O(S)/token)"
        return cell

    if sd["step"] == "train":
        accum = _accum_for(full, batch, seq, mesh)
        state_sds, state_sh = _state_specs(cfg, mesh)
        step_fn = make_sharded_train_step(lm_loss, cfg, mesh, state_sh.params, accum=accum,
                                          remat=True)
        if accum > 1:
            bshape = (accum, batch // accum, seq)
            bspec = (None, dp, None)
        else:
            bshape = (batch, seq)
            bspec = (dp, None)
        batch_sds = {"tokens": _sds(bshape, I32), "labels": _sds(bshape, I32)}
        bsh = tree_map(lambda _: Sharding(mesh, bspec), batch_sds)
        return Cell(
            arch, shape, "lm", "train",
            fn=step_fn,
            args=(state_sds, batch_sds),
            in_shardings=(state_sh, bsh),
            model_flops=_lm_train_flops(cfg, batch * seq),
            note=f"accum={accum} remat=on",
        )

    if sd["step"] == "prefill":
        params_sds = lm_init(cfg, device=META)
        params_sh = param_sharding(params_sds, mesh)

        def fn(params, tokens):
            """This rank's DP block of the prompts, the weights gathered."""
            return prefill(gather(params, params_sh), tokens, cfg, max_len=seq)

        return Cell(
            arch, shape, "lm", "prefill",
            fn=fn,
            args=(params_sds, _sds((batch, seq), I32)),
            in_shardings=(params_sh, Sharding(mesh, (dp, None))),
            model_flops=2.0 * cfg.active_param_count() * batch * seq,
        )

    return _lm_decode_cell(arch, shape, cfg, mesh, seq, batch)


def _lm_decode_cell(arch, shape, cfg, mesh, seq, batch) -> Cell:
    dp = dp_axes_of(mesh)
    params_sds = lm_init(cfg, device=META)
    params_sh = param_sharding(params_sds, mesh)
    cache_sds = init_cache(cfg, batch, seq, device=META)
    cache_sh = _cache_sharding(cache_sds, mesh, batch)

    # the cache's sequence blocks only: its batch blocks stay with the tokens'
    seq_sh = tree_map(lambda sh: Sharding(mesh, tuple(e if i == 2 else None
                                                      for i, e in enumerate(sh.spec))),
                      cache_sh)

    def fn(params, cache, tokens, pos):
        """One step on this rank's blocks: the weights and the cache's
        sequence blocks gathered at use (its batch blocks are this rank's
        tokens'), the new cache cut into sequence blocks again.  A fake
        ``pos`` (a shapes-only trace) stands for the last position: the step
        attends the whole cache under a mask wherever it writes."""
        pos = seq - 1 if is_fake(pos) else int(pos)
        logits, new = decode_step(gather(params, params_sh), gather(cache, seq_sh), tokens,
                                  pos, cfg)
        return logits, place(new, seq_sh)

    tok_spec = (dp,) if batch % _dp_size(mesh) == 0 else ()
    return Cell(
        arch, shape, "lm", "decode",
        fn=fn,
        args=(params_sds, cache_sds, _sds((batch,), I32), _sds((), I32)),
        in_shardings=(params_sh, cache_sh, Sharding(mesh, tok_spec), Sharding(mesh, ())),
        model_flops=2.0 * cfg.active_param_count() * batch,
        note="KV sequence dim sharded over model axis (split-KV)",
    )


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------

_GNN_SHAPE_DEFS = {
    # (n_nodes, n_edges, d_feat, task-style, shard_nodes)
    "full_graph_sm": dict(n=2708, e=10556, d=1433, shard_nodes=False),
    "minibatch_lg": dict(n=169984, e=168960, d=128, shard_nodes=True,
                         note="sampled blocks: 1024 seeds × fanout 15·10"),
    "ogb_products": dict(n=2449029, e=61859140, d=100, shard_nodes=True),
    "molecule": dict(n=3840, e=8192, d=32, shard_nodes=False,
                     note="batch=128 graphs × 30 atoms / 64 bonds"),
}


def _gnn_flops(arch: str, cfg: GNNConfig, n: int, e: int) -> float:
    d = cfg.d_hidden
    if arch == "gcn-cora":
        f = 2 * n * cfg.d_in * d + 2 * n * d * cfg.d_out + 4 * e * d
    elif arch == "meshgraphnet":
        f = cfg.n_layers * (8 * e * d * d + 6 * n * d * d)
    elif arch == "schnet":
        f = cfg.n_layers * (2 * e * (cfg.n_rbf * d + d * d) + 6 * n * d * d)
    else:  # graphcast: processor on mesh (n/4 nodes, e/2 edges)
        f = cfg.n_layers * (8 * (e // 2) * d * d + 6 * (n // 4) * d * d)
        f += 2 * n * cfg.d_in * d + 2 * n * d * cfg.d_out
    return 3.0 * f          # fwd + bwd


def _gathered_loss(loss_fn: Callable, batch_sh):
    """``loss_fn`` on the whole graph, gathered at use from this rank's
    blocks: every rank computes the global loss (GSPMD's semantics for a
    graph whose edges cross the blocks)."""

    def loss(params, g, cfg):
        return loss_fn(params, gather(g, batch_sh), cfg)

    return loss


def build_gnn_cell(arch: str, shape: str, mesh) -> Cell:
    base_cfg: GNNConfig = arch_config(arch)
    model = importlib.import_module(f"repro_torch.models.gnn.{GNN_ARCHS[arch][1]}")
    sd = _GNN_SHAPE_DEFS[shape]
    n_logical, e_logical, d_feat = sd["n"], sd["e"], sd["d"]
    dp = dp_axes_of(mesh)
    dp_size = _dp_size(mesh)

    n = _pad_to(n_logical) if sd["shard_nodes"] else n_logical
    e = _pad_to(e_logical)

    cfg = dataclasses.replace(base_cfg, d_in=d_feat)
    is_mol = shape == "molecule"
    n_graphs = 128 if is_mol else 1

    # labels per task
    if cfg.task == "node_class":
        labels = _sds((n,), I32)
    elif cfg.task == "graph_reg":
        labels = _sds((n_graphs, cfg.d_out), F32)
    else:
        labels = _sds((n, cfg.d_out), F32)

    g_sds = GraphBatch(
        node_feat=_sds((n, d_feat), F32),
        senders=_sds((e,), I32),
        receivers=_sds((e,), I32),
        edge_feat=_sds((e, cfg.d_edge), F32) if cfg.d_edge else None,
        pos=_sds((n, 3), F32) if arch in ("schnet", "graphcast") else None,
        graph_ids=_sds((n,), I32) if is_mol else None,
        labels=labels,
    )

    shard_nodes = sd["shard_nodes"] and n % dp_size == 0
    shard_edges = e % dp_size == 0

    def sh(*spec):
        return Sharding(mesh, tuple(spec))

    rep = sh()

    if cfg.task == "node_class":
        labels_sh = sh(dp) if shard_nodes else rep
    elif cfg.task == "graph_reg":
        labels_sh = rep
    else:
        labels_sh = sh(dp, None) if shard_nodes else rep

    g_sh = GraphBatch(
        node_feat=sh(dp, None) if shard_nodes else rep,
        senders=sh(dp) if shard_edges else rep,
        receivers=sh(dp) if shard_edges else rep,
        edge_feat=(sh(dp, None) if shard_edges else rep) if cfg.d_edge else None,
        pos=rep if g_sds.pos is not None else None,
        graph_ids=rep if g_sds.graph_ids is not None else None,
        labels=labels_sh,
    )

    state_sds = init_train_state(model.init_params(cfg, device=META))
    state_sh = param_sharding(state_sds, mesh)
    step_fn = make_sharded_train_step(_gathered_loss(model.loss, g_sh), cfg, mesh,
                                      state_sh.params)

    return Cell(
        arch, shape, "gnn", "train",
        fn=step_fn,
        args=(state_sds, g_sds),
        in_shardings=(state_sh, g_sh),
        model_flops=_gnn_flops(arch, cfg, n_logical, e_logical),
        note=sd.get("note", "") + f" padded n={n} e={e}",
    )


# --------------------------------------------------------------------------
# recsys cells
# --------------------------------------------------------------------------

_RECSYS_SHAPE_DEFS = {
    "train_batch": dict(batch=65536, step="train"),
    "serve_p99": dict(batch=512, step="serve"),
    "serve_bulk": dict(batch=262144, step="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, step="retrieval"),
}


def _recsys_batch_sds(cfg, batch: int):
    return {
        "user_ids": _sds((batch, cfg.user_fields, cfg.field_hots), I32),
        "item_ids": _sds((batch, cfg.item_fields, cfg.field_hots), I32),
        "user_dense": _sds((batch, cfg.n_dense_feat), F32),
        "log_q": _sds((batch,), F32),
    }


def _recsys_flops(cfg, batch: int, train: bool) -> float:
    d = cfg.embed_dim
    bag = (cfg.user_fields + cfg.item_fields) * cfg.field_hots * d * batch
    dims_u = (cfg.user_fields * d + cfg.n_dense_feat,) + cfg.tower_dims
    dims_i = (cfg.item_fields * d,) + cfg.tower_dims
    mlp = sum(2 * a * b for a, b in zip(dims_u[:-1], dims_u[1:]))
    mlp += sum(2 * a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
    f = bag + batch * mlp + 2 * batch * batch * cfg.tower_dims[-1]
    return (3.0 if train else 1.0) * f


def build_recsys_cell(arch: str, shape: str, mesh) -> Cell:
    from repro_torch.models.recsys import two_tower as tt

    cfg = arch_config(arch)
    sd = _RECSYS_SHAPE_DEFS[shape]
    batch = sd["batch"]
    dp = dp_axes_of(mesh)
    dp_size = _dp_size(mesh)

    params_sds = tt.init_params(cfg, device=META)
    params_sh = param_sharding(params_sds, mesh)

    if sd["step"] == "train":
        def loss_fn(params, batch_, cfg_, **kw):
            return tt.loss_sharded(params, batch_, cfg_, mesh=mesh, dp_axes=dp)

        state_sds = init_train_state(tt.init_params(cfg, device=META))
        state_sh = param_sharding(state_sds, mesh)
        # loss_sharded takes the tables' vocab blocks itself: nothing is gathered
        step_fn = make_sharded_train_step(loss_fn, cfg, mesh, state_sh.params,
                                          local=lambda path, leaf: True)
        b_sds = _recsys_batch_sds(cfg, batch)
        b_sh = batch_sharding(b_sds, mesh)
        return Cell(
            arch, shape, "recsys", "train",
            fn=step_fn,
            args=(state_sds, b_sds),
            in_shardings=(state_sh, b_sh),
            model_flops=_recsys_flops(cfg, batch, True),
            note="vocab-sharded tables, shard_map masked-lookup+psum bags",
        )

    if sd["step"] == "serve":
        def fn(params, batch_):
            return tt.serve_scores(params, batch_, cfg, mesh=mesh, dp_axes=dp)

        b_sds = _recsys_batch_sds(cfg, batch)
        b_sh = batch_sharding(b_sds, mesh)
        return Cell(
            arch, shape, "recsys", "serve",
            fn=fn,
            args=(params_sds, b_sds),
            in_shardings=(params_sh, b_sh),
            model_flops=_recsys_flops(cfg, batch, False),
        )

    # retrieval: one query batch against 1M pre-embedded candidates
    n_cand = sd["n_candidates"]
    b_sds = _recsys_batch_sds(cfg, batch)
    b_sh = tree_map(lambda _: Sharding(mesh, ()), b_sds)
    cand_sds = _sds((n_cand, cfg.tower_dims[-1]), F32)
    cand_sh = Sharding(mesh, (dp, None) if n_cand % dp_size == 0 else ("data", None))

    def fn(params, batch_, cand):
        """The tables and the corpus gathered at use, then one GEMM + top-k."""
        return tt.retrieval_scores(gather(params, params_sh), batch_, gather(cand, cand_sh),
                                   cfg, top_k=100)

    flops = 2.0 * n_cand * cfg.tower_dims[-1] * batch
    return Cell(
        arch, shape, "recsys", "retrieval",
        fn=fn,
        args=(params_sds, b_sds, cand_sds),
        in_shardings=(params_sh, b_sh, cand_sh),
        model_flops=flops,
        note="single GEMM vs 1M candidates + distributed top-k",
    )


def build_cell(arch: str, shape: str, mesh) -> Cell:
    if arch in LM_ARCHS:
        return build_lm_cell(arch, shape, mesh)
    if arch in GNN_ARCHS:
        return build_gnn_cell(arch, shape, mesh)
    return build_recsys_cell(arch, shape, mesh)
