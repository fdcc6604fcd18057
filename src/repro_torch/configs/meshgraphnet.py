"""meshgraphnet [arXiv:2010.03409]: 15 MP layers, d=128, sum agg, 2-layer MLPs."""

from repro_torch.models.gnn.common import GNNConfig

FULL = GNNConfig(
    name="meshgraphnet", arch="meshgraphnet", n_layers=15, d_hidden=128,
    d_in=16, d_edge=4, d_out=3, aggregator="sum", mlp_layers=2, task="node_reg",
)

SMOKE = GNNConfig(
    name="meshgraphnet-smoke", arch="meshgraphnet", n_layers=3, d_hidden=16,
    d_in=8, d_edge=4, d_out=3, aggregator="sum", mlp_layers=2, task="node_reg",
)
