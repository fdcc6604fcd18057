"""Models on torch: the two-tower retrieval model (``models.recsys``:
serving, training and its vocab-sharded form) and the transformer LMs
(``models.transformer``: serving; LM training and the GNNs are later work,
ROADMAP A11)."""
