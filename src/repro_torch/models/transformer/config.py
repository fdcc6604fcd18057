"""Transformer configuration covering the five LM architectures: the
reference's fields, defaults and order, with torch dtypes."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    max_seq: int = 4096

    activation: str = "swiglu"         # swiglu | geglu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    scale_embeddings: bool = False     # gemma: embed * sqrt(d_model)
    rope_theta: float = 10_000.0

    # attention flavor
    attention: str = "gqa"             # gqa | mla
    # MLA (DeepSeek-V2): compressed-KV latent attention
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 2
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_prefix: int = 0            # leading dense (non-MoE) layers
    router_aux_coef: float = 0.01

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def q_head_dim(self) -> int:
        if self.attention == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS in the roofline)."""
        d, h, kv, hd, v = (
            self.d_model,
            self.n_heads,
            self.n_kv_heads,
            self.head_dim,
            self.vocab,
        )
        n = v * d                                        # embeddings
        if not self.tie_embeddings:
            n += v * d
        per_layer_attn = 0
        if self.attention == "mla":
            qd = self.qk_nope_head_dim + self.qk_rope_head_dim
            per_layer_attn += d * h * qd                       # W_q
            per_layer_attn += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            per_layer_attn += self.kv_lora_rank * h * self.qk_nope_head_dim
            per_layer_attn += self.kv_lora_rank * h * self.v_head_dim
            per_layer_attn += h * self.v_head_dim * d          # W_o
        else:
            per_layer_attn += d * h * hd + 2 * d * kv * hd + h * hd * d
        dense_ffn = 3 * d * self.d_ff
        if self.moe:
            expert_ffn = 3 * d * self.d_ff_expert
            moe_ffn = self.n_experts * expert_ffn + d * self.n_experts
            moe_ffn += self.n_shared_experts * expert_ffn
            n_moe_layers = self.n_layers - self.n_dense_prefix
            n += n_moe_layers * (per_layer_attn + moe_ffn)
            n += self.n_dense_prefix * (per_layer_attn + dense_ffn)
        else:
            n += self.n_layers * (per_layer_attn + dense_ffn)
        n += self.n_layers * 2 * d + d                   # norms
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: 6·N_active·D model flops)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        expert_ffn = 3 * d * self.d_ff_expert
        total = self.param_count()
        n_moe_layers = self.n_layers - self.n_dense_prefix
        inactive = n_moe_layers * (self.n_experts - self.top_k) * expert_ffn
        return total - inactive
