"""qwen2-7b [arXiv:2407.10671; hf]: 28L d=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias, SwiGLU."""

from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    max_seq=32768,
)

SMOKE = TransformerConfig(
    name="qwen2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    dtype="float32",
    param_dtype="float32",
    max_seq=128,
)
