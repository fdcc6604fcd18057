"""two-tower-retrieval [Yi et al., RecSys'19]: embed_dim=256,
towers 1024-512-256, dot interaction, sampled softmax w/ logQ."""

from repro_torch.models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="two-tower-retrieval",
    embed_dim=256,
    tower_dims=(1024, 512, 256),
    user_vocab=5_000_000,
    item_vocab=2_000_000,
    user_fields=4,
    item_fields=2,
    field_hots=8,
    n_dense_feat=13,
)

SMOKE = RecsysConfig(
    name="two-tower-smoke",
    embed_dim=16,
    tower_dims=(32, 16),
    user_vocab=1000,
    item_vocab=500,
    user_fields=2,
    item_fields=2,
    field_hots=4,
    n_dense_feat=5,
)
