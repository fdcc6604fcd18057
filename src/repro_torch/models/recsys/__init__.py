from repro_torch.models.recsys.two_tower import RecsysConfig, TwoTower

__all__ = ["RecsysConfig", "TwoTower"]
