"""GIN [arXiv:1810.00826]: n_layers=5 d_hidden=64 sum aggregator,
learnable eps.  Node tasks use a fixed 64-class head (synthetic labels);
molecule shape is graph-level regression through the same head."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GNNConfig

ARCH = ArchSpec(
    id="gin-tu",
    family="gnn",
    gnn_kind="gin",
    model_cfg=GNNConfig(name="gin-tu", n_layers=5, d_hidden=64, d_in=1433,
                        n_classes=64, task="node", learn_eps=True),
    smoke_cfg=GNNConfig(name="gin-smoke", n_layers=2, d_hidden=16, d_in=8,
                        n_classes=4, task="node"),
    shapes=dict(GNN_SHAPES),
    param_rules={"ffn": None},
    notes="d_in fixed to the largest assigned d_feat (1433); smaller "
          "feature shapes are zero-padded by the data pipeline",
)
