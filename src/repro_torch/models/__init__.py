"""Models on torch.  So far the two-tower retrieval model's serving path
(``models.recsys``); the rest of the reference's zoo is later work."""
