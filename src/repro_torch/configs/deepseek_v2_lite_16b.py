"""deepseek-v2-lite-16b [arXiv:2405.04434; hf].

27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6,
MLA kv_lora=512, 2 shared experts.  (The assignment line lists both "64e
top-6" and "160 routed"; the real V2-Lite has 64 routed experts — we follow
the explicit 64e top-6 numbers, as the reference does.)  First layer is dense
(d_ff=10944) per the HF config.
"""

from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,                 # dense prefix layer
    vocab=102400,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    n_dense_prefix=1,
    max_seq=32768,
)

SMOKE = TransformerConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    attention="mla",
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    moe=True,
    n_experts=8,
    top_k=2,
    n_shared_experts=2,
    d_ff_expert=32,
    n_dense_prefix=1,
    dtype="float32",
    param_dtype="float32",
    max_seq=128,
)
