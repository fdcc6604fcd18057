"""Architecture registry: ``--arch`` names → configuration modules, the
input shapes of each architecture's cells, and their analytic MODEL_FLOPS.

The reference's registry also builds each (architecture × input shape) cell
as a lowerable step with shardings for the dry run; that is XLA's and has no
counterpart here.  The shape tables and the FLOP counts are plain data and
cross unchanged.
"""

from __future__ import annotations

import importlib

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


def _lm_train_flops(cfg, tokens: int) -> float:
    return 6.0 * cfg.active_param_count() * tokens


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


def _gnn_flops(arch: str, cfg, n: int, e: int) -> float:
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
