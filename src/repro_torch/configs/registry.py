"""Architecture registry: ``--arch`` names → configuration modules.

The reference's registry also holds the (architecture × input shape) cells,
their shardings and their lowering for the dry run; those are XLA's and
have no counterpart here.  The GNN architectures wait for the GNN slice
(ROADMAP A11).
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
RECSYS_ARCHS = {"two-tower-retrieval": "repro_torch.configs.two_tower_retrieval"}


def arch_config(arch: str, smoke: bool = False):
    """The FULL (or, with ``smoke``, the SMOKE) configuration of ``arch``."""
    if arch in LM_ARCHS:
        mod = importlib.import_module(LM_ARCHS[arch])
    elif arch in RECSYS_ARCHS:
        mod = importlib.import_module(RECSYS_ARCHS[arch])
    else:
        raise KeyError(f"unknown arch {arch!r}: the port has {sorted(LM_ARCHS)} and "
                       f"{sorted(RECSYS_ARCHS)} (the GNNs wait for ROADMAP A11)")
    return mod.SMOKE if smoke else mod.FULL
