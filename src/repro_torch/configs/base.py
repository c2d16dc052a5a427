"""Arch config registry, a copy of ``repro/configs/base.py`` for the port.

Every ported architecture gets one module in this package exposing an
``ARCH: ArchSpec``.  ``get_arch(id)`` / ``list_archs()`` are the CLI entry
points (``--arch <id>``).  The port has all ten of the reference's
architectures: five LMs (the dense GQA ones, OLMoE's MoE and DeepSeek-V3's
MLA, MoE and MTP), four GNNs (GIN, EGNN, NequIP, DimeNet) and the FM
recommender.  ``configs/families.py`` holds the GNN initialisers and
losses and the dry run's cells (``build_cell``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class LMShape:
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


@dataclasses.dataclass(frozen=True)
class GNNShape:
    kind: str            # "full" | "minibatch" | "molecule"
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch: int = 0            # molecule: graphs per batch
    batch_nodes: int = 0      # minibatch: global seed nodes
    fanout: tuple = ()        # minibatch fanouts
    max_nodes: int = 0        # molecule: nodes per graph
    max_edges: int = 0


@dataclasses.dataclass(frozen=True)
class RecShape:
    kind: str            # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str                       # "lm" | "gnn" | "recsys"
    model_cfg: Any
    smoke_cfg: Any
    shapes: dict[str, Any]
    param_rules: dict[str, Any]
    skip_shapes: dict[str, str] = dataclasses.field(default_factory=dict)
    gnn_kind: str = ""                # "gin" | "egnn" | "nequip" | "dimenet"
    moment_dtype: str = "float32"     # optimizer moment dtype
    param_dtype: str = "float32"      # parameter storage dtype at scale
    accum_steps: int = 1              # microbatch gradient accumulation
                                      # (bounds MoE dispatch buffers)
    lm_batch_axes: Any = None         # None = DP axes; "ALL" = every mesh
                                      # axis (pure-DP for small models)
    grad_dtype: str = ""              # "" = native; "bfloat16" halves the
                                      # DP gradient all-reduce
    notes: str = ""


_ARCH_MODULES = [
    "olmoe_1b_7b", "deepseek_v3_671b", "qwen3_0_6b", "gemma3_1b",
    "h2o_danube_1_8b", "dimenet", "gin_tu", "nequip", "egnn", "fm",
]


def list_archs() -> list[str]:
    """Every architecture's id, in the reference's order."""
    return [importlib.import_module(f"repro_torch.configs.{m}").ARCH.id
            for m in _ARCH_MODULES]


def get_arch(arch_id: str) -> ArchSpec:
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        if mod.ARCH.id == arch_id:
            return mod.ARCH
    raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")


def all_archs() -> list[ArchSpec]:
    return [importlib.import_module(f"repro_torch.configs.{m}").ARCH
            for m in _ARCH_MODULES]


# the canonical shape sets from the assignment
LM_SHAPES = {
    "train_4k": LMShape("train", 4096, 256),
    "prefill_32k": LMShape("prefill", 32768, 32),
    "decode_32k": LMShape("decode", 32768, 128),
    "long_500k": LMShape("decode", 524288, 1),
}

GNN_SHAPES = {
    "full_graph_sm": GNNShape("full", n_nodes=2708, n_edges=10556,
                              d_feat=1433),
    "minibatch_lg": GNNShape("minibatch", n_nodes=232965,
                             n_edges=114615892, batch_nodes=1024,
                             fanout=(15, 10)),
    "ogb_products": GNNShape("full", n_nodes=2449029, n_edges=61859140,
                             d_feat=100),
    "molecule": GNNShape("molecule", batch=128, max_nodes=30, max_edges=64),
}

REC_SHAPES = {
    "train_batch": RecShape("train", 65536),
    "serve_p99": RecShape("serve", 512),
    "serve_bulk": RecShape("serve", 262144),
    "retrieval_cand": RecShape("retrieval", 1, n_candidates=1_000_000),
}
