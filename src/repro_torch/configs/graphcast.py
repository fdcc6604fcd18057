"""graphcast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN,
16 processor layers, d=512, n_vars=227, mesh refinement 6 (mesh ≈ grid/4)."""

from repro_torch.models.gnn.common import GNNConfig

FULL = GNNConfig(
    name="graphcast", arch="graphcast", n_layers=16, d_hidden=512,
    d_in=227, d_out=227, aggregator="sum", n_vars=227, task="node_reg",
)

SMOKE = GNNConfig(
    name="graphcast-smoke", arch="graphcast", n_layers=2, d_hidden=32,
    d_in=11, d_out=11, aggregator="sum", n_vars=11, task="node_reg",
)
