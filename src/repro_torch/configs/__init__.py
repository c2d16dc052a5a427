"""Arch config registry of the port, a copy of ``repro/configs`` over the
ported (LM) architectures."""
from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, REC_SHAPES,
                                      ArchSpec, all_archs, get_arch,
                                      list_archs)

__all__ = ["ArchSpec", "GNN_SHAPES", "LM_SHAPES", "REC_SHAPES", "all_archs",
           "get_arch", "list_archs"]
