"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean/sym-norm agg."""

from repro_torch.models.gnn.common import GNNConfig

FULL = GNNConfig(
    name="gcn-cora", arch="gcn", n_layers=2, d_hidden=16,
    d_in=1433, d_out=7, aggregator="mean", task="node_class",
)

SMOKE = GNNConfig(
    name="gcn-smoke", arch="gcn", n_layers=2, d_hidden=8,
    d_in=16, d_out=4, aggregator="mean", task="node_class",
)
