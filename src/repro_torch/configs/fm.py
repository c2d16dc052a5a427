"""Factorization Machine [Rendle ICDM'10]: 39 sparse fields, embed_dim=10,
pairwise interactions via the O(nk) sum-square trick.  Tables: 2^20 rows
per field (Criteo-scale), row-sharded over the model axis."""
from repro_torch.configs.base import ArchSpec, REC_SHAPES
from repro_torch.models.fm import FMConfig

ARCH = ArchSpec(
    id="fm",
    family="recsys",
    model_cfg=FMConfig(name="fm", n_fields=39, embed_dim=10,
                       rows_per_field=1 << 20),
    smoke_cfg=FMConfig(name="fm-smoke", n_fields=8, embed_dim=4,
                       rows_per_field=128),
    shapes=dict(REC_SHAPES),
    param_rules={"table_rows": "model"},
)
