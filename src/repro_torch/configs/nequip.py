"""NequIP [arXiv:2101.03164]: n_layers=5 d_hidden(channels)=32 l_max=2
n_rbf=8 cutoff=5, O(3)-equivariant tensor products (Gaunt coupling)."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.nequip import NequIPConfig

ARCH = ArchSpec(
    id="nequip",
    family="gnn",
    gnn_kind="nequip",
    model_cfg=NequIPConfig(name="nequip", n_layers=5, channels=32, n_rbf=8,
                           cutoff=5.0, n_species=8),
    smoke_cfg=NequIPConfig(name="nequip-smoke", n_layers=2, channels=8,
                           n_rbf=4, cutoff=5.0, n_species=4),
    shapes=dict(GNN_SHAPES),
    param_rules={"ffn": None},
)
