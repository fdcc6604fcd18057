"""gemma-2b [arXiv:2403.08295]: 18L d=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256, tied + scaled embeddings."""

from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    max_seq=32768,
)

SMOKE = TransformerConfig(
    name="gemma-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab=256,
    activation="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    dtype="float32",
    param_dtype="float32",
    max_seq=128,
)
