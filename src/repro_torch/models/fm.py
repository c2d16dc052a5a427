"""Factorization Machine [Rendle, ICDM'10], the port of
``repro/models/fm.py``: one concatenated embedding table of
``n_fields × rows_per_field`` rows.

Lookups are ``index_select``, so a table's gradient is dense, as the
reference's ``jnp.take`` gradient is (and the optimizer decays every row
of ``v``, a 2-D leaf).  The multi-hot bags sum through
:func:`repro_torch.models.gnn.segment_sum` (JAX's semantics: the dummy
bag id ``n_bags`` is dropped).  The pairwise interaction uses the O(nk)
sum-square identity:

    Σ_{i<j} <v_i, v_j> x_i x_j = ½ (‖Σ_i v_i x_i‖² − Σ_i ‖v_i x_i‖²).

Single-hot fields (Criteo-style, (B, F) ids) and multi-hot bags (flat ids
with a bag id each).  :func:`fm_axes` is the reference's row sharding of
the table (``"table_rows"``), which
:mod:`repro_torch.distributed.sharding` turns into DTensor placements.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models.gnn import segment_sum
from repro_torch.models.layers import dense_init, take_rows
from repro_torch.models.transformer import (float32_matmuls,
                                            init_generator, model_device)


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str
    n_fields: int = 39
    embed_dim: int = 10
    rows_per_field: int = 100_000     # single concatenated table
    n_dense: int = 0                  # optional dense features

    @property
    def total_rows(self) -> int:
        return self.n_fields * self.rows_per_field


class FM(nn.Module):
    """``init_fm``'s tree: the factor table ``v`` (total_rows, k), the
    first-order weights ``w`` (total_rows,), the bias ``b`` and, with
    dense features, ``w_dense`` (n_dense,)."""

    def __init__(self, cfg: FMConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = model_device(generator, device)
        self.cfg = cfg
        self.v = nn.Parameter(dense_init(
            generator, (cfg.total_rows, cfg.embed_dim), cfg.embed_dim,
            device).mul_(0.1))
        self.w = nn.Parameter(dense_init(generator, (cfg.total_rows,), 1,
                                         device).mul_(0.01))
        self.b = nn.Parameter(torch.zeros((), device=device))
        if cfg.n_dense:
            self.w_dense = nn.Parameter(dense_init(
                generator, (cfg.n_dense,), cfg.n_dense, device))


def fm_axes(cfg: FMConfig) -> dict[str, tuple]:
    """The FM's logical axes (the reference's ``fm_axes``): table rows
    on "table_rows"."""
    a = {"v": ("table_rows", None), "w": ("table_rows",), "b": ()}
    if cfg.n_dense:
        a["w_dense"] = (None,)
    return a


def init_fm(cfg: FMConfig, generator: torch.Generator | None = None,
            device=None) -> FM:
    return FM(cfg, *init_generator(generator, device))


def _take(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, rows, axis=0)`` for in-range rows: (*rows.shape,
    *table.shape[1:]); shard-locally on DTensors
    (:func:`~repro_torch.models.layers.take_rows`)."""
    if isinstance(table, DTensor) or isinstance(rows, DTensor):
        return take_rows(table, rows)
    out = table.index_select(0, rows.reshape(-1))
    return out.reshape(*rows.shape, *table.shape[1:])


def _flatten_ids(cfg: FMConfig, ids: torch.Tensor) -> torch.Tensor:
    """Per-field ids (B, F) -> rows in the concatenated table."""
    offs = torch.arange(cfg.n_fields, dtype=ids.dtype,
                        device=ids.device) * cfg.rows_per_field
    return ids + offs[None, :]


def _pairwise(v: torch.Tensor) -> torch.Tensor:
    """(B, F, k) -> (B,): the sum-square identity."""
    s = v.sum(dim=1)                                 # (B, k)
    s2 = (v * v).sum(dim=1)                          # (B, k)
    return 0.5 * (s * s - s2).sum(dim=-1)


def apply_fm(p: FM, cfg: FMConfig, ids: torch.Tensor,
             dense: torch.Tensor | None = None) -> torch.Tensor:
    """ids (B, F) int in [0, rows_per_field).  Returns logits (B,)."""
    rows = _flatten_ids(cfg, ids)
    v = _take(p.v, rows)                             # (B, F, k)
    w = _take(p.w, rows)                             # (B, F)
    out = p.b + w.sum(dim=1) + _pairwise(v)
    if dense is not None and cfg.n_dense:
        with float32_matmuls(dense.dtype):
            out = out + dense @ p.w_dense
    return out


def apply_fm_bags(p: FM, cfg: FMConfig, flat_ids: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int) -> torch.Tensor:
    """Multi-hot EmbeddingBag variant: flat table rows (L,) with bag id
    per entry (L,) in [0, n_bags); bag = one (example, field) pair.  Dummy
    entries use bag id ``n_bags``.  Returns logits (n_bags // n_fields,)."""
    v = _take(p.v, flat_ids)                         # (L, k)
    w = _take(p.w, flat_ids)                         # (L,)
    v_bag = segment_sum(v, bag_ids, n_bags + 1)[:-1]
    w_bag = segment_sum(w, bag_ids, n_bags + 1)[:-1]
    B = n_bags // cfg.n_fields
    v_bf = v_bag.reshape(B, cfg.n_fields, cfg.embed_dim)
    return p.b + w_bag.reshape(B, cfg.n_fields).sum(dim=1) + _pairwise(v_bf)


def fm_retrieval_scores(p: FM, cfg: FMConfig, query_ids: torch.Tensor,
                        cand_ids: torch.Tensor) -> torch.Tensor:
    """Retrieval scoring: one query (Fq,) against N candidate items (N,
    Fc) as one batched dot.  Query fields and candidate fields are
    disjoint field groups; the score is the FM cross term between the two
    groups plus the candidates' first-order terms."""
    Fq = query_ids.shape[0]
    dev = query_ids.device
    q_rows = query_ids + torch.arange(Fq, dtype=query_ids.dtype,
                                      device=dev) * cfg.rows_per_field
    q_vec = _take(p.v, q_rows).sum(dim=0)                       # (k,)
    Fc = cand_ids.shape[1]
    c_off = (Fq + torch.arange(Fc, dtype=cand_ids.dtype, device=dev)) \
        * cfg.rows_per_field
    c_rows = cand_ids + c_off[None, :]
    c_vec = _take(p.v, c_rows).sum(dim=1)                       # (N, k)
    c_w = _take(p.w, c_rows).sum(dim=1)                         # (N,)
    with float32_matmuls(c_vec.dtype):
        return c_vec @ q_vec + c_w


def fm_loss(p: FM, cfg: FMConfig, ids, labels, dense=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits, in the reference's stable
    form."""
    logits = apply_fm(p, cfg, ids, dense)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
