"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 32 experts top-8, no shared experts, tied embeddings.
"""

from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    moe=True,
    n_experts=32,
    top_k=8,
    n_shared_experts=0,
    d_ff_expert=512,
    tie_embeddings=True,
    max_seq=32768,
)

SMOKE = TransformerConfig(
    name="granite-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=256,
    moe=True,
    n_experts=4,
    top_k=2,
    d_ff_expert=32,
    tie_embeddings=True,
    dtype="float32",
    param_dtype="float32",
    max_seq=128,
)
