"""EGNN [arXiv:2102.09844]: n_layers=4 d_hidden=64, E(n)-equivariant."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import EGNNConfig

ARCH = ArchSpec(
    id="egnn",
    family="gnn",
    gnn_kind="egnn",
    model_cfg=EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_in=16),
    smoke_cfg=EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_in=8),
    shapes=dict(GNN_SHAPES),
    param_rules={"ffn": None},
)
