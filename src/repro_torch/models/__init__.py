"""Models on torch.  So far the two-tower retrieval model (``models.recsys``):
serving, training and its vocab-sharded form; the rest of the reference's
zoo is later work (ROADMAP A11)."""
