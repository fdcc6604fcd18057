"""Models on torch: the two-tower retrieval model (``models.recsys``:
serving, training and its vocab-sharded form), the transformer LMs
(``models.transformer``: serving and training) and the GNNs
(``models.gnn``: GCN, MeshGraphNet, SchNet, GraphCast)."""
