"""Decoder-only transformer LMs (GQA/MQA or MLA attention, dense GLU or MoE
FFNs) as functions of a parameter dict in the reference's stacked layout."""

from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.model import (
    init_params,
    forward,
    lm_loss,
    init_cache,
    prefill,
    decode_step,
)

__all__ = [
    "TransformerConfig",
    "init_params",
    "forward",
    "lm_loss",
    "init_cache",
    "prefill",
    "decode_step",
]
