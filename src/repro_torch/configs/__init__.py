"""Arch config registry of the port, a copy of ``repro/configs`` over all
ten architectures, and ``configs/families.py``: the GNN initialisers and
losses and the dry run's cells."""
from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, REC_SHAPES,
                                      ArchSpec, GNNShape, LMShape, RecShape,
                                      all_archs, get_arch, list_archs)
from repro_torch.configs.families import gnn_init, gnn_single_loss

__all__ = ["ArchSpec", "GNNShape", "GNN_SHAPES", "LMShape", "LM_SHAPES",
           "RecShape", "REC_SHAPES", "all_archs", "get_arch", "gnn_init",
           "gnn_single_loss", "list_archs"]
