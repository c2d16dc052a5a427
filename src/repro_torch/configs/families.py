"""The GNN half of ``repro/configs/families.py`` for the port: a GNN
arch's initialiser and its loss over one graph batch.

Only that half is here.  The reference's dry-run half (``Cell``,
``lm_cell``, ``gnn_cell``, ``rec_cell``, the shardings and
``build_cell``) is the model mesh, ROADMAP.md queue 1 item 13e, and is
not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models import dimenet as DM
from repro_torch.models import gnn as G
from repro_torch.models import nequip as NQ

_INITS = {"gin": G.init_gin, "egnn": G.init_egnn,
          "nequip": NQ.init_nequip, "dimenet": DM.init_dimenet}


def gnn_init(arch: ArchSpec, generator: torch.Generator | None = None,
             device=None):
    """The model of ``arch.model_cfg`` (the reference's
    ``_gnn_init_and_axes`` without the axes): drawn from ``generator`` on
    ``device``, the card unless the caller asks for the CPU."""
    if arch.gnn_kind not in _INITS:
        raise ValueError(arch.gnn_kind)
    return _INITS[arch.gnn_kind](arch.model_cfg, generator, device)


def gnn_single_loss(arch: ArchSpec, remat: bool):
    """The reference's ``_gnn_single_loss``: ``loss(model, batch)`` over
    ONE graph batch, a dict of tensors on the model's device (``model``
    may be :func:`repro_torch.models.transformer.bind`'s view)."""
    kind = arch.gnn_kind
    cfg = arch.model_cfg

    def loss(p, b):
        if kind == "gin":
            # per-shape task: graph regression when "targets" present,
            # node classification otherwise (same params either way)
            if "targets" in b:
                cfg_eff = dataclasses.replace(cfg, task="graph", n_graphs=1)
                logits = G.apply_gin(p, cfg_eff, b["node_feat"],
                                     b["senders"], b["receivers"],
                                     b["graph_ids"], remat=remat)
                return torch.mean((logits[0, 0] - b["targets"]) ** 2)
            logits = G.apply_gin(p, cfg, b["node_feat"], b["senders"],
                                 b["receivers"], remat=remat)
            lp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.take_along_dim(lp, b["labels"][:, None].long(),
                                        dim=1)[:, 0]
            w = b["train_mask"].float()
            return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        if kind == "egnn":
            e, _ = G.apply_egnn(p, cfg, b["node_feat"], b["pos"],
                                b["senders"], b["receivers"],
                                b.get("graph_ids"), remat=remat)
            return torch.mean((e - b["targets"]) ** 2)
        if kind == "nequip":
            e = NQ.apply_nequip(p, cfg, b["species"], b["pos"],
                                b["senders"], b["receivers"],
                                b.get("graph_ids"), remat=remat)
            return torch.mean((e - b["targets"]) ** 2)
        if kind == "dimenet":
            e = DM.apply_dimenet(p, cfg, b["species"], b["pos"],
                                 b["senders"], b["receivers"], b["t_kj"],
                                 b["t_ji"], b.get("graph_ids"), remat=remat)
            return torch.mean((e - b["targets"]) ** 2)
        raise ValueError(kind)

    return loss
