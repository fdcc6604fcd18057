"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBFs, cutoff 10 Å."""

from repro_torch.models.gnn.common import GNNConfig

FULL = GNNConfig(
    name="schnet", arch="schnet", n_layers=3, d_hidden=64,
    d_in=16, d_out=1, n_rbf=300, cutoff=10.0, task="graph_reg",
)

SMOKE = GNNConfig(
    name="schnet-smoke", arch="schnet", n_layers=2, d_hidden=16,
    d_in=8, d_out=1, n_rbf=30, cutoff=10.0, task="graph_reg",
)
