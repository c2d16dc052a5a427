"""DimeNet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6; triplet cap = 2x edges on full-graph shapes,
4x edges on molecule batches (DESIGN §4)."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.dimenet import DimeNetConfig

ARCH = ArchSpec(
    id="dimenet",
    family="gnn",
    gnn_kind="dimenet",
    model_cfg=DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                            n_bilinear=8, n_spherical=7, n_radial=6,
                            cutoff=5.0, n_species=8),
    smoke_cfg=DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=16,
                            n_bilinear=4, n_spherical=3, n_radial=3,
                            n_species=4),
    shapes=dict(GNN_SHAPES),
    param_rules={"ffn": None},
)
