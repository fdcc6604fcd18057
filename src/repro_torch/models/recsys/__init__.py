from repro_torch.models.recsys.two_tower import (
    RecsysConfig,
    TwoTower,
    init_params,
    user_tower,
    item_tower,
    forward,
    loss,
    retrieval_scores,
)

__all__ = [
    "RecsysConfig",
    "TwoTower",
    "init_params",
    "user_tower",
    "item_tower",
    "forward",
    "loss",
    "retrieval_scores",
]
