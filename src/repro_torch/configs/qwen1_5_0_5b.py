"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d=1024 16H (kv=16, MHA)
d_ff=2816 vocab=151936, QKV bias, tied embeddings."""

from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen1.5-0.5b",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    max_seq=32768,
)

SMOKE = TransformerConfig(
    name="qwen1.5-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
    dtype="float32",
    param_dtype="float32",
    max_seq=128,
)
