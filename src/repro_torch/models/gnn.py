"""GNN models, the port of ``repro/models/gnn.py``: the segment-sum
message-passing substrate, the two-layer MLP, GIN and EGNN.

Graph batches have fixed shapes: ``node_feat`` (N+1, F) with a zero
dummy row N, ``senders``/``receivers`` (E,) integer ids padded with the
dummy node N, and ``graph_ids`` (N+1,) for a per-graph readout (dummy =
G).  Aggregation is :func:`segment_sum`, which keeps
``jax.ops.segment_sum``'s semantics: ids outside ``[0, num)`` are
dropped, where ``index_add_`` would raise on the CPU and fail a device
assert on the card.  :func:`one_hot` keeps ``jax.nn.one_hot``'s: an id
outside ``[0, n)`` gives a zero row.  Every segment sum and one-hot of
the GNN and recsys models and of ``launch/train.py`` goes through these
two.

Models are ``nn.Module``s whose parameter names follow the reference's
pytree paths (``layers.0.mlp.w1`` for ``params["layers"][0]["mlp"]["w1"]``),
drawn from an explicit :class:`torch.Generator` with ``layers.dense_init``
on the card unless the caller asks for the CPU (no card:
:class:`~repro_torch.errors.ConfigError`).  The ``apply_*`` functions
take the module (or :func:`repro_torch.models.transformer.bind`'s view of
it over the reference's leaves) and the config, as the reference takes
its params and config, and run where the parameters are; in float32
their matmuls run with TF32 off
(:func:`~repro_torch.models.transformer.float32_matmuls`).  ``remat``
runs each layer under ``torch.utils.checkpoint`` (non-reentrant), where
the reference has ``jax.checkpoint``.  :func:`gin_axes`,
:func:`egnn_axes` and :func:`mlp2_axes` are the reference's sharding
rules (:mod:`repro_torch.distributed.sharding` reads them).  On DTensor
batches whose edges are sharded, :func:`gather_rows` and
:func:`segment_sum` run shard-locally: each rank gathers and sums its
own edges, and one all-reduce completes the node sums.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import flatten_axes
from repro_torch.models.layers import _stride, dense_init, to_local
from repro_torch.models.transformer import (float32_matmuls,
                                            init_generator, model_device)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int = 0            # node/graph classification head size
    task: str = "node"            # "node" | "graph" | "energy"
    # GIN
    learn_eps: bool = True
    # EGNN / NequIP / DimeNet extras live in their own configs
    n_graphs: int = 1             # graphs per batch (graph-level tasks)


# ---------------------------------------------------------------------------
# the substrate: segment sums and one-hot with JAX's out-of-range semantics
# ---------------------------------------------------------------------------
def segment_sum(vals: torch.Tensor, seg: torch.Tensor, num: int
                ) -> torch.Tensor:
    """``jax.ops.segment_sum(vals, seg, num)``: (num, *vals.shape[1:]),
    row ``i`` the sum of the rows of ``vals`` whose id is ``i``.  An id
    outside ``[0, num)`` (negative, ``num`` or beyond) is dropped, with its
    value and its gradient: the mask sends it to a spare row ``num`` of the
    zeroed sum, which is cut off, so no id reaches ``index_add_`` out of
    range."""
    keep = (seg >= 0) & (seg < num)
    idx = torch.where(keep, seg, num)
    if isinstance(vals, DTensor):
        return _segment_sum_sharded(vals, idx, num)
    out = vals.new_zeros((num + 1, *vals.shape[1:]))
    return out.index_add(0, idx, vals)[:num]


def edgewise(fn, rows: tuple, consts: tuple = ()):
    """``fn(*rows, *consts)`` for an ``fn`` that treats each row (an edge,
    a triplet) alone and returns a tensor or a list or tuple of them,
    each a row a row.  When a row input is a DTensor of split rows, each
    rank applies ``fn`` to its own rows (``consts`` whole), and the
    outputs are split as the rows are; a constant's gradient is a
    partial sum over the split.  Plain inputs: ``fn`` as it is."""
    d = next((t for t in rows if isinstance(t, DTensor)), None)
    if d is None:
        return fn(*rows, *consts)
    mesh = d.device_mesh
    split = [i for i, p in enumerate(d.placements) if p == Shard(0)]
    pl = tuple(Shard(0) if i in split else Replicate()
               for i in range(mesh.ndim))
    part = tuple(Partial() if i in split else Replicate()
                 for i in range(mesh.ndim))
    out = fn(*(to_local(t, pl, mesh) for t in rows),
             *(to_local(t, (Replicate(),) * mesh.ndim, mesh,
                        grad_placements=part) for t in consts))

    def whole(o):
        shape = (d.shape[0], *o.shape[1:])
        return DTensor.from_local(o.contiguous(), mesh, pl, run_check=False,
                                  shape=shape,
                                  stride=_stride(shape))
    if isinstance(out, (list, tuple)):
        return type(out)(whole(o) for o in out)
    return whole(out)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]``.  With ``idx`` a DTensor of row-sharded ids (edges,
    triplets), each rank gathers its own rows from the whole of ``x``
    (node features are replicated already; a sharded ``x`` is gathered
    first): the result is sharded as ``idx`` is, and the backward pass's
    scatter-add leaves partial gradients, which one all-reduce completes
    (GSPMD's partition of the reference's gather)."""
    if not isinstance(idx, DTensor):
        return x[idx]
    mesh = idx.device_mesh
    rows = [i for i, p in enumerate(idx.placements) if p == Shard(0)]
    pl = tuple(Shard(0) if i in rows else Replicate()
               for i in range(mesh.ndim))
    x_l = to_local(x, (Replicate(),) * mesh.ndim, mesh,
                   grad_placements=tuple(Partial() if i in rows else
                                         Replicate()
                                         for i in range(mesh.ndim)))
    out = x_l[to_local(idx, pl, mesh)]
    shape = (idx.shape[0], *out.shape[1:])
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=_stride(shape))


def _segment_sum_sharded(vals: DTensor, idx, num: int) -> DTensor:
    """:func:`segment_sum` of DTensor rows (edges sharded over mesh dims):
    each rank sums its own rows into all ``num`` segments, and the
    partial sums are all-reduced, so every rank holds the whole sums, as
    the model's replicated node features are (GSPMD's partition of the
    reference's scatter-add)."""
    mesh = vals.device_mesh
    rows = [i for i, p in enumerate(vals.placements) if p == Shard(0)]
    pl = tuple(Shard(0) if i in rows else Replicate()
               for i in range(mesh.ndim))
    v_l = to_local(vals, pl, mesh)
    i_l = to_local(idx, pl, mesh)
    out = v_l.new_zeros((num + 1, *v_l.shape[1:])).index_add(0, i_l, v_l)
    part = tuple(Partial() if i in rows else Replicate()
                 for i in range(mesh.ndim))
    return DTensor.from_local(out[:num], mesh, part, run_check=False
                              ).redistribute(mesh, (Replicate(),) * mesh.ndim)


def segment_mean(vals: torch.Tensor, seg: torch.Tensor, num: int
                 ) -> torch.Tensor:
    """The reference's ``segment_mean``: the segment sum over the count
    of ids in each segment (at least 1)."""
    s = segment_sum(vals, seg, num)
    c = segment_sum(vals.new_ones(vals.shape[:1]), seg, num)
    c = torch.clamp(c, min=1.0)
    return s / c[..., None] if vals.dim() > 1 else s / c


def one_hot(ids: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot(ids, n, dtype=dtype)``: (*ids.shape, n), with an
    all-zero row for an id outside ``[0, n)`` (``F.one_hot`` raises on
    one)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _live_rows(n1: int, dtype, device) -> torch.Tensor:
    """(n1, 1): 1 for the real rows, 0 for the dummy row n1 - 1."""
    return (torch.arange(n1, device=device) < n1 - 1).to(dtype)[:, None]


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): only the inputs are kept for the backward pass,
    which runs ``fn`` again."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ---------------------------------------------------------------------------
# the two-layer MLP
# ---------------------------------------------------------------------------
class MLP2(nn.Module):
    """``mlp2_init``: ``w1`` (d_in, d_hid), ``b1``, ``w2`` (d_hid, d_out),
    ``b2``, the biases zero."""

    def __init__(self, d_in: int, d_hid: int, d_out: int,
                 generator: torch.Generator, device):
        super().__init__()
        self.w1 = nn.Parameter(dense_init(generator, (d_in, d_hid), d_in,
                                          device))
        self.b1 = nn.Parameter(torch.zeros(d_hid, device=device))
        self.w2 = nn.Parameter(dense_init(generator, (d_hid, d_out), d_hid,
                                          device))
        self.b2 = nn.Parameter(torch.zeros(d_out, device=device))


def mlp2_apply(p: MLP2, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(x @ p.w1.to(x.dtype) + p.b1.to(x.dtype))
    return h @ p.w2.to(x.dtype) + p.b2.to(x.dtype)


# ---------------------------------------------------------------------------
# GIN  [arXiv:1810.00826] — n_layers=5 d=64 sum aggregator, learnable eps
# ---------------------------------------------------------------------------
def mlp2_axes() -> dict:
    return {"w1": (None, "ffn"), "b1": ("ffn",),
            "w2": ("ffn", None), "b2": (None,)}


def gin_axes(cfg: GNNConfig) -> dict[str, tuple]:
    """GIN's logical axes, ``{path: axes}`` over its parameter paths (the
    reference's ``gin_axes``)."""
    return flatten_axes({"layers": [{"mlp": mlp2_axes(), "eps": ()}
                                    for _ in range(cfg.n_layers)],
                         "head": (None, None)})


class GINLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, generator, device):
        super().__init__()
        self.mlp = MLP2(d_in, d_hidden, d_hidden, generator, device)
        self.eps = nn.Parameter(torch.zeros((), device=device))


class GIN(nn.Module):
    """``init_gin``'s tree: ``layers`` (``mlp``, ``eps``) and ``head``
    (d_hidden, n_classes)."""

    def __init__(self, cfg: GNNConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = model_device(generator, device)
        self.cfg = cfg
        self.layers = nn.ModuleList()
        d = cfg.d_in
        for _ in range(cfg.n_layers):
            self.layers.append(GINLayer(d, cfg.d_hidden, generator, device))
            d = cfg.d_hidden
        self.head = nn.Parameter(dense_init(
            generator, (cfg.d_hidden, cfg.n_classes), cfg.d_hidden, device))


def init_gin(cfg: GNNConfig, generator: torch.Generator | None = None,
             device=None) -> GIN:
    return GIN(cfg, *init_generator(generator, device))


def apply_gin(p: GIN, cfg: GNNConfig, node_feat, senders, receivers,
              graph_ids=None, remat: bool = False) -> torch.Tensor:
    """node_feat (N+1, F) with zero dummy row.  Returns logits: node task
    -> (N+1, C); graph task -> (G, C)."""
    n1 = node_feat.shape[0]
    remat = remat and torch.is_grad_enabled()
    live = _live_rows(n1, torch.bool, node_feat.device)

    def layer(h, lp):
        agg = segment_sum(gather_rows(h, senders), receivers, n1)
        eps = lp.eps if cfg.learn_eps else 0.0
        h = mlp2_apply(lp.mlp, (1.0 + eps) * h + agg)
        return h * live                     # keep the dummy row zero

    with float32_matmuls(node_feat.dtype):
        h = node_feat
        for lp in p.layers:
            h = _remat(layer, h, lp) if remat else layer(h, lp)
        if cfg.task == "graph":
            pooled = segment_sum(h, graph_ids, cfg.n_graphs + 1)
            return pooled[:-1] @ p.head.to(h.dtype)
        return h @ p.head.to(h.dtype)


# ---------------------------------------------------------------------------
# EGNN  [arXiv:2102.09844] — n_layers=4 d=64 E(n)-equivariant
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int
    n_graphs: int = 1
    coord_agg: str = "mean"


def egnn_axes(cfg: EGNNConfig) -> dict[str, tuple]:
    """EGNN's logical axes (the reference's ``egnn_axes``)."""
    return flatten_axes({"embed": (None, "ffn"),
                         "layers": [{"phi_e": mlp2_axes(),
                                     "phi_x": mlp2_axes(),
                                     "phi_h": mlp2_axes()}
                                    for _ in range(cfg.n_layers)],
                         "head": mlp2_axes()})


class EGNNLayer(nn.Module):
    def __init__(self, d: int, generator, device):
        super().__init__()
        self.phi_e = MLP2(2 * d + 1, d, d, generator, device)
        self.phi_x = MLP2(d, d, 1, generator, device)
        self.phi_h = MLP2(2 * d, d, d, generator, device)


class EGNN(nn.Module):
    """``init_egnn``'s tree: ``embed`` (d_in, d), ``layers`` (``phi_e``,
    ``phi_x``, ``phi_h``) and the ``head`` MLP."""

    def __init__(self, cfg: EGNNConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = model_device(generator, device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.layers = nn.ModuleList(EGNNLayer(d, generator, device)
                                    for _ in range(cfg.n_layers))
        self.embed = nn.Parameter(dense_init(generator, (cfg.d_in, d),
                                             cfg.d_in, device))
        self.head = MLP2(d, d, 1, generator, device)


def init_egnn(cfg: EGNNConfig, generator: torch.Generator | None = None,
              device=None) -> EGNN:
    return EGNN(cfg, *init_generator(generator, device))


def apply_egnn(p: EGNN, cfg: EGNNConfig, node_feat, pos, senders, receivers,
               graph_ids=None, remat: bool = False):
    """node_feat (N+1, F), pos (N+1, 3).  Returns the per-graph scalar
    (G,) (the energy-style readout; the total, a 0-d tensor, without
    ``graph_ids``) and the final coordinates (N+1, 3)."""
    n1 = node_feat.shape[0]
    remat = remat and torch.is_grad_enabled()
    live = _live_rows(n1, node_feat.dtype, node_feat.device)

    def layer(h, x, lp):
        d_vec = gather_rows(x, senders) - gather_rows(x, receivers)
        d2 = torch.sum(d_vec * d_vec, dim=-1, keepdim=True)
        m = mlp2_apply(lp.phi_e, torch.cat([gather_rows(h, senders),
                                            gather_rows(h, receivers), d2],
                                           -1))
        m = F.silu(m)
        # coordinate update (receiver-centric): x_i += agg_j (x_i - x_j) phi_x
        w = mlp2_apply(lp.phi_x, m)
        upd = segment_mean(-d_vec * w, receivers, n1) \
            if cfg.coord_agg == "mean" else \
            segment_sum(-d_vec * w, receivers, n1)
        x = x + upd * live
        agg = segment_sum(m, receivers, n1)
        h = h + mlp2_apply(lp.phi_h, torch.cat([h, agg], -1))
        return h * live, x

    with float32_matmuls(node_feat.dtype):
        h = node_feat @ p.embed.to(node_feat.dtype)
        x = pos
        for lp in p.layers:
            h, x = _remat(layer, h, x, lp) if remat else layer(h, x, lp)
        node_e = mlp2_apply(p.head, h)[:, 0]
    if graph_ids is None:
        return node_e.sum(), x
    return segment_sum(node_e, graph_ids, cfg.n_graphs + 1)[:-1], x
