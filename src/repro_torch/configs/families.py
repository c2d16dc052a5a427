"""Family builders, the port of ``repro/configs/families.py``: a GNN
arch's initialiser and its loss over one graph batch, and the dry-run
cells, ``(arch, shape, mesh) -> Cell``.

A :class:`Cell` holds a step function and its arguments: DTensors over
the mesh, each placed by its :class:`~repro_torch.distributed.sharding.
Sharding` (the reference attaches ``NamedSharding``s to
``ShapeDtypeStruct``s).  The dry run builds them inside a
``FakeTensorMode`` over :func:`~repro_torch.launch.mesh.fake_mesh`, so
no width is cut and nothing is allocated: the model's skeleton lives on
the ``meta`` device, and each leaf is a fake local block.  A cell's step
is the port's own step (``train.loop.make_train_step`` over ``lm_loss``,
``fm_loss`` or a GNN loss, ``prefill``, ``decode_step``, ``apply_fm``,
``fm_retrieval_scores``) run on those leaves; DTensor partitions it, as
GSPMD partitions the reference's.  :meth:`Cell.trace` runs it once, under
``implicit_replication`` (the tensors the model makes for itself act as
replicated) and the caller's counters.

The reference's graph-level GNN cells ``vmap`` a one-graph loss over a
graph axis sharded over the mesh.  Here each rank loops over its own
graphs (:func:`_graph_level_loss`, a ``shard_map`` by hand): the
parameters enter as local tensors whose gradients are partial sums over
the sharded axes, and the per-graph losses leave as a DTensor sharded
like the graphs.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchSpec, GNNShape, LMShape, RecShape
from repro_torch.distributed.sharding import (Sharding, cast_float_leaves,
                                              fake_dtensor, local_nbytes,
                                              replicated, tree_shardings)
from repro_torch.launch.mesh import dp_axes, dp_size, mesh_axes
from repro_torch.models import dimenet as DM
from repro_torch.models import fm as FM
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import nequip as NQ
from repro_torch.models import transformer as T
from repro_torch.models.layers import LMConfig
from repro_torch.train import optim
from repro_torch.train.loop import TrainConfig, TrainState, make_train_step

_INITS = {"gin": G.init_gin, "egnn": G.init_egnn,
          "nequip": NQ.init_nequip, "dimenet": DM.init_dimenet}
_AXES = {"gin": G.gin_axes, "egnn": G.egnn_axes,
         "nequip": NQ.nequip_axes, "dimenet": DM.dimenet_axes}


def gnn_init(arch: ArchSpec, generator: torch.Generator | None = None,
             device=None):
    """The model of ``arch.model_cfg`` (the reference's
    ``_gnn_init_and_axes`` without the axes): drawn from ``generator`` on
    ``device``, the card unless the caller asks for the CPU (``"meta"``:
    shapes alone)."""
    if arch.gnn_kind not in _INITS:
        raise ValueError(arch.gnn_kind)
    return _INITS[arch.gnn_kind](arch.model_cfg, generator, device)


def gnn_axes(arch: ArchSpec) -> dict[str, tuple]:
    """The GNN's ``{path: logical axes}`` (the axes half of
    ``_gnn_init_and_axes``)."""
    return _AXES[arch.gnn_kind](arch.model_cfg)


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


# ---------------------------------------------------------------------------
# the dry-run cell
# ---------------------------------------------------------------------------
def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _all_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for child in tree for t in _leaves(child)]
    return []


def tree_nbytes(tree) -> int:
    """A rank's bytes of every tensor of ``tree`` (its local blocks)."""
    return sum(local_nbytes(t) for t in _leaves(tree))


@dataclasses.dataclass
class Cell:
    """One dry-run cell: a step and its DTensor arguments, made under
    ``fake_mode``.  ``out_bytes`` is a rank's bytes of the step's
    outputs, from their shardings (the reference's ``out_shardings``);
    ``donated`` the argument bytes the outputs replace (the train
    state).  ``probe`` names the reduced-layer twins whose costs
    :func:`repro_torch.launch.dryrun._probe_costs` extrapolates."""
    fn: Callable
    args: tuple
    fake_mode: Any = None
    static_desc: str = ""
    out_bytes: int = 0
    donated: int = 0
    probe: Any = None
    act_spec: Any = None          # embedding-output placements
    replicated_ops: int = 0       # ops the dry run's fallback replicated

    def arg_bytes(self) -> int:
        return tree_nbytes(self.args)

    def trace(self, *modes):
        """Run the step once on its fake arguments, inside ``modes`` (the
        dry run's counters, entered last so they see the local ops
        first), with the cell's activation layout set.  Returns the
        step's output."""
        T.set_act_spec(self.act_spec)
        try:
            with self.fake_mode, implicit_replication():
                for m in modes:
                    m.__enter__()
                try:
                    return self.fn(*self.args)
                finally:
                    for m in reversed(modes):
                        m.__exit__(None, None, None)
        finally:
            T.set_act_spec(None)


# ---------------------------------------------------------------------------
# shared: optimizer-state shaping
# ---------------------------------------------------------------------------
def train_state_shapes(params: dict, moment_dtype: torch.dtype
                       ) -> TrainState:
    """The AdamW train state of ``params`` ({path: tensor}, any device) as
    meta tensors."""
    zeros = {k: torch.empty(p.shape, dtype=moment_dtype, device="meta")
             for k, p in params.items()}
    step = torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params=params,
                      opt_state=optim.OptState(step=step, m=zeros,
                                               v=dict(zeros)),
                      step=step)


def train_state_shardings(params_shardings: dict, mesh) -> TrainState:
    rep = replicated(mesh)
    return TrainState(params=params_shardings,
                      opt_state=optim.OptState(step=rep, m=params_shardings,
                                               v=params_shardings),
                      step=rep)


def _attach(shapes, shardings):
    """Fake DTensors of ``shapes``' shapes and dtypes placed by
    ``shardings`` (trees of one structure), under the caller's fake
    mode.  A 0-d integer leaf (a step count) stays a plain tensor."""
    if isinstance(shapes, torch.Tensor):
        if shapes.dim() == 0 and not shapes.is_floating_point():
            return torch.zeros((), dtype=shapes.dtype)
        return fake_dtensor(shapes.shape, shapes.dtype, shardings)
    if isinstance(shapes, dict):
        return {k: _attach(v, shardings[k]) for k, v in shapes.items()}
    if isinstance(shapes, tuple) and hasattr(shapes, "_fields"):
        return type(shapes)(*(_attach(a, b) for a, b in zip(shapes,
                                                            shardings)))
    return type(shapes)(_attach(a, b) for a, b in zip(shapes, shardings))


def _sds(shape, dtype, mesh, spec: tuple) -> DTensor:
    return fake_dtensor(shape, dtype, Sharding(mesh, spec))


def _raw_train_step(loss_fn, moment_dtype, accum_steps: int = 1,
                    grad_dtype=None):
    tcfg = TrainConfig(optimizer="adamw", moment_dtype=moment_dtype,
                       accum_steps=accum_steps, grad_dtype=grad_dtype)
    return make_train_step(loss_fn, tcfg)


def _train_out_bytes(state) -> int:
    """A train step's outputs: the new state (donated in place of the
    old) and three replicated float32 metrics."""
    return tree_nbytes(state) + 3 * 4


def _fake_buffers(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` (a ``meta`` skeleton) with each buffer a fake tensor of
    its shape, made under the caller's fake mode (NequIP's Gaunt
    tensors): the step mixes buffers with the fake leaves."""
    for mod in model.modules():
        for name, buf in list(mod._buffers.items()):
            if buf is not None:
                mod._buffers[name] = torch.zeros(buf.shape, dtype=buf.dtype)
    return model


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _lm_skeleton(cfg: LMConfig) -> T.TransformerLM:
    return T.init_lm(cfg, device="meta")


def _spec_axes(spec: tuple) -> set:
    """The mesh axes a spec names."""
    out = set()
    for entry in spec:
        out.update(entry if isinstance(entry, tuple) else
                   () if entry is None else (entry,))
    return out


def lm_params_shapes(cfg: LMConfig, param_dtype: torch.dtype) -> dict:
    """{path: meta tensor}: the model's leaves in ``param_dtype``."""
    return cast_float_leaves(T.reference_leaves(_lm_skeleton(cfg)),
                             param_dtype)


def lm_param_shardings(arch: ArchSpec, cfg: LMConfig, shapes: dict,
                       mesh) -> dict:
    return tree_shardings(T.lm_axes(cfg), shapes, arch.param_rules, mesh)


def _lm_cache_shardings(arch: ArchSpec, cfg: LMConfig, cache_shapes: list,
                        mesh, batch: int) -> list[dict]:
    """Per-layer cache shardings: batch over DP when divisible, else KV
    length over (data, model), sequence-parallel decode for batch 1."""
    dp = dp_axes(mesh)
    dpn = dp_size(mesh)
    sizes = mesh_axes(mesh)
    out = []
    for layer_cache in cache_shapes:
        lc = {}
        for name, s in layer_cache.items():
            dims: list = [None] * len(s.shape)
            if batch % dpn == 0 and batch >= dpn:
                dims[0] = dp
                # shard kv heads or length over model
                if name in ("k", "v") and s.shape[2] % sizes.get(
                        "model", 1) == 0 and s.shape[2] >= sizes["model"]:
                    dims[2] = "model"
                elif s.shape[1] % sizes.get("model", 1) == 0:
                    dims[1] = "model"
            else:
                if s.shape[1] % math.prod(mesh.shape) == 0:
                    dims[1] = _all_axes(mesh)
                elif s.shape[1] % sizes["model"] == 0:
                    dims[1] = "model"
            lc[name] = Sharding(mesh, tuple(dims))
        out.append(lc)
    return out


def _probe_cfgs(cfg: LMConfig):
    """Two reduced-layer-count twins (l1 < l2) varying the biggest layer
    group; returns (cfg1, cfg2, l1, l2, l_full)."""
    if cfg.is_moe and cfg.n_dense_layers > 0:
        l_full = cfg.n_layers - cfg.n_dense_layers   # moe group varies
        base = cfg.n_dense_layers
    else:
        l_full = cfg.n_layers
        base = 0
    if l_full < 5:
        return None
    l1, l2 = 2, 4
    c1 = dataclasses.replace(cfg, n_layers=base + l1)
    c2 = dataclasses.replace(cfg, n_layers=base + l2)
    return c1, c2, l1, l2, l_full


def lm_cell(arch: ArchSpec, shape: LMShape, mesh, fake_mode, *,
            _probing: Any = False, _probe_accum: int | None = None,
            _probe_batch: int | None = None) -> Cell:
    cfg: LMConfig = arch.model_cfg
    if _probing is not False:
        cfg = _probing
    if _probe_accum is not None:
        arch = dataclasses.replace(arch, accum_steps=_probe_accum)
    if _probe_batch is not None:
        shape = dataclasses.replace(shape, global_batch=_probe_batch)
    pdt = _dtype(arch.param_dtype)
    mdt = _dtype(arch.moment_dtype)
    dp = (_all_axes(mesh) if arch.lm_batch_axes == "ALL"
          else (arch.lm_batch_axes or dp_axes(mesh)))
    dpn = math.prod(mesh_axes(mesh)[a] for a in dp)
    model = _lm_skeleton(cfg)
    p_shapes = lm_params_shapes(cfg, pdt)
    p_shard = lm_param_shardings(arch, cfg, p_shapes, mesh)
    act_spec = Sharding(mesh, (dp, None, None))
    probe_args = dict(arch=arch, shape=shape, mesh=mesh, fake_mode=fake_mode)

    if shape.kind == "train":
        B, S = shape.global_batch, shape.seq_len
        # a micro-batch of fewer rows than the DP ranks (DeepSeek's 16 of
        # 256 on the multi-pod mesh's 32): the leading DP axes replicate
        # it, one row a rank, the work GSPMD's padded split does
        while dp and (B // arch.accum_steps) % dpn:
            dp = tuple(dp[1:])
            dpn = math.prod(mesh_axes(mesh)[a] for a in dp)
        idle = [a for a in mesh.mesh_dim_names if a not in dp and not any(
            a in _spec_axes(sh.spec) for sh in p_shard.values())]
        if idle:
            # an axis that shards nothing only repeats the work: every
            # rank along it computes the same, so a rank's costs are those
            # on the mesh without it (DTensor would shard its free dims over
            # it, into layouts it plans slowly)
            mesh = mesh[tuple(a for a in mesh.mesh_dim_names
                              if a not in idle)]
            p_shard = lm_param_shardings(arch, cfg, p_shapes, mesh)
            probe_args["mesh"] = mesh
        act_spec = Sharding(mesh, (dp or None, None, None))
        micro_tokens = (B // arch.accum_steps) * S
        moe_groups = dpn if micro_tokens % dpn == 0 else 1
        moe_spec = (dp, "model") if cfg.is_moe else None

        def loss_fn(p, b):
            return T.lm_loss(T.bind(model, p), b,
                             compute_dtype=torch.bfloat16,
                             moe_groups=moe_groups, remat=True,
                             moe_spec=moe_spec)

        step = _raw_train_step(loss_fn, mdt, arch.accum_steps,
                               _dtype(arch.grad_dtype)
                               if arch.grad_dtype else None)
        with fake_mode:
            state_in = _attach(train_state_shapes(p_shapes, mdt),
                               train_state_shardings(p_shard, mesh))
            batch_in = _sds((B, S), torch.int64, mesh, (dp or None, None))
        probe = None
        if _probing is False:
            pc = _probe_cfgs(cfg)
            if pc is not None:
                c1, c2, l1, l2, lf = pc
                A = arch.accum_steps
                if A > 2:
                    # bilinear probe: cost(L, A) = a + bA + cL + dAL, four
                    # small twins at the same micro-batch.  Accumulation
                    # 2 and 3, where the reference takes 1 and 2: a step
                    # of one micro-batch runs no accumulation ops at all,
                    # so it is off the line the larger counts lie on
                    mb = B // A
                    cells = [lm_cell(arch, shape, mesh, fake_mode,
                                     _probing=lc, _probe_accum=a,
                                     _probe_batch=a * mb)
                             for lc in (c1, c2) for a in (2, 3)]
                    probe = ("bilinear", cells, (l1, l2), (2, 3), (lf, A))
                else:
                    probe = ("linear",
                             lm_cell(_probing=c1, **probe_args),
                             lm_cell(_probing=c2, **probe_args),
                             l1, l2, lf)
        return Cell(fn=step, args=(state_in, batch_in), fake_mode=fake_mode,
                    out_bytes=_train_out_bytes(state_in),
                    donated=tree_nbytes(state_in), probe=probe,
                    act_spec=act_spec,
                    static_desc=f"train_step B={B} S={S}" + (
                        f" (idle {','.join(idle)}: traced on "
                        f"{'x'.join(mesh.mesh_dim_names)})" if idle else ""))

    cache_shapes = T.make_cache(cfg, shape.global_batch, shape.seq_len,
                                dtype=torch.bfloat16, device="meta")
    cache_shard = _lm_cache_shardings(arch, cfg, cache_shapes, mesh,
                                      shape.global_batch)
    with fake_mode:
        params_in = _attach(p_shapes, p_shard)
        caches = _attach(cache_shapes, cache_shard)

    if shape.kind == "prefill":
        B, S = shape.global_batch, shape.seq_len

        def fn(params, tokens):
            return T.prefill(T.bind(model, params), tokens, max_len=S,
                             compute_dtype=torch.bfloat16)

        with fake_mode:
            tokens_in = _sds((B, S), torch.int64, mesh, (dp, None))
        # explicit outputs: last-position logits over dp, the caches
        # batch- or head-sharded
        out = B // dpn * cfg.vocab * 4 + tree_nbytes(caches)
        probe = None
        if _probing is False and S > 1024:
            pc = _probe_cfgs(cfg)
            if pc is not None:
                c1, c2, l1, l2, lf = pc
                probe = ("linear", lm_cell(_probing=c1, **probe_args),
                         lm_cell(_probing=c2, **probe_args), l1, l2, lf)
        return Cell(fn=fn, args=(params_in, tokens_in), fake_mode=fake_mode,
                    out_bytes=out, probe=probe, act_spec=act_spec,
                    static_desc=f"prefill B={B} S={S}")

    # decode
    B, S = shape.global_batch, shape.seq_len

    def fn(params, caches, tokens, pos):
        return T.decode_step(T.bind(model, params), caches, tokens, pos,
                             compute_dtype=torch.bfloat16)

    on_dp = B % dpn == 0 and B >= dpn
    with fake_mode:
        tokens_in = _sds((B, 1), torch.int64, mesh,
                         (dp, None) if on_dp else (None, None))
        pos_in = _sds((B,), torch.int64, mesh, (dp,) if on_dp else (None,))
    out = (B // dpn if on_dp else B) * cfg.vocab * 4 + tree_nbytes(caches)
    return Cell(fn=fn, args=(params_in, caches, tokens_in, pos_in),
                fake_mode=fake_mode, out_bytes=out,
                static_desc=f"decode B={B} KV={S}")


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------
def _gnn_full_batch_shapes(arch: ArchSpec, shape: GNNShape, mesh) -> dict:
    """Full-graph batch: nodes replicated, edge (and triplet) arrays
    sharded across ALL mesh axes."""
    kind = arch.gnn_kind
    ndev = math.prod(mesh.shape)
    all_ax = _all_axes(mesh)
    N1 = shape.n_nodes + 1
    E = _round_up(shape.n_edges, ndev)
    i32, bf16 = torch.int32, torch.bfloat16
    b = {"senders": _sds((E,), i32, mesh, (all_ax,)),
         "receivers": _sds((E,), i32, mesh, (all_ax,))}
    if kind == "gin":
        # feature width is the model's d_in; shapes with smaller d_feat
        # are zero-padded by the data pipeline
        b["node_feat"] = _sds((N1, arch.model_cfg.d_in), bf16, mesh, ())
        b["labels"] = _sds((N1,), i32, mesh, ())
        b["train_mask"] = _sds((N1,), torch.bool, mesh, ())
    else:
        b["pos"] = _sds((N1, 3), bf16, mesh, ())
        b["targets"] = torch.zeros((), dtype=bf16)
        if kind == "egnn":
            b["node_feat"] = _sds((N1, arch.model_cfg.d_in), bf16, mesh, ())
        else:
            b["species"] = _sds((N1,), i32, mesh, ())
        if kind == "dimenet":
            Tn = _round_up(2 * shape.n_edges, ndev)
            b["t_kj"] = _sds((Tn,), i32, mesh, (all_ax,))
            b["t_ji"] = _sds((Tn,), i32, mesh, (all_ax,))
    return b


def _gnn_graph_level_shapes(arch: ArchSpec, n_graphs: int, max_nodes: int,
                            max_edges: int, mesh, spec_axes,
                            with_labels: bool) -> dict:
    """Per-graph stacked arrays (G, ...) sharded on the leading axis."""
    kind = arch.gnn_kind
    N1 = max_nodes + 1
    i32, bf16 = torch.int32, torch.bfloat16

    def lead(dtype, *rest):
        return _sds((n_graphs, *rest), dtype, mesh,
                    (spec_axes,) + (None,) * len(rest))

    b = {"senders": lead(i32, max_edges), "receivers": lead(i32, max_edges)}
    if kind == "gin":
        b["node_feat"] = lead(bf16, N1, arch.model_cfg.d_in)
        if with_labels:
            b["labels"] = lead(i32, N1)
            b["train_mask"] = lead(torch.bool, N1)
        else:
            b["targets"] = lead(bf16)
            b["graph_ids"] = lead(i32, N1)
    else:
        b["pos"] = lead(bf16, N1, 3)
        b["targets"] = lead(bf16)
        if kind == "egnn":
            b["node_feat"] = lead(bf16, N1, arch.model_cfg.d_in)
        else:
            b["species"] = lead(i32, N1)
        if kind == "dimenet":
            b["t_kj"] = lead(i32, 4 * max_edges)
            b["t_ji"] = lead(i32, 4 * max_edges)
    return b


def _graph_level_loss(loss1, model, mesh, spec_axes):
    """``loss(params, batch)``, the mean of ``loss1`` over the graphs of
    a batch whose leading (graph) axis is sharded over ``spec_axes``:
    each rank runs ``loss1`` on its own graphs, one after another."""
    sharded = [a in spec_axes for a in mesh.mesh_dim_names]
    grad_pl = tuple(Partial() if s else Replicate() for s in sharded)
    loss_pl = tuple(Shard(0) if s else Replicate() for s in sharded)

    def loss(params, b):
        local_p = {k: L.to_local(v, v.placements, grad_placements=grad_pl)
                   for k, v in params.items()}
        local_b = {k: v.to_local() for k, v in b.items()}
        view = T.bind(model, local_p)
        n_local = local_b["senders"].shape[0]
        losses = torch.stack([
            loss1(view, {k: v[i] for k, v in local_b.items()})
            for i in range(n_local)])
        n_graphs = b["senders"].shape[0]
        return DTensor.from_local(losses, mesh, loss_pl, run_check=False,
                                  shape=(n_graphs,), stride=(1,)
                                  ).sum() / n_graphs

    return loss


def _flat_mesh(mesh):
    """``mesh``'s ranks as one axis (named by joining its axes): sharding
    over it is sharding over all of ``mesh``'s axes at once."""
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1),
                      mesh_dim_names=("_".join(mesh.mesh_dim_names),))


def gnn_cell(arch: ArchSpec, shape: GNNShape, mesh, fake_mode) -> Cell:
    mdt = _dtype(arch.moment_dtype)
    model = gnn_init(arch, device="meta")
    with fake_mode:
        _fake_buffers(model)
    p_shapes = cast_float_leaves(T.reference_leaves(model),
                                 _dtype(arch.param_dtype))
    p_shard = tree_shardings(gnn_axes(arch), p_shapes, arch.param_rules,
                             mesh)
    if shape.kind == "full" and mesh.ndim > 1 and \
            all(e is None for sh in p_shard.values() for e in sh.spec):
        # parameters and nodes replicated, edges over every axis: the same
        # layout on the flattened mesh, where DTensor shards the edge axis
        # over one mesh dim (over two, its einsums reshape into strided
        # shards it cannot multiply) and reduces over all ranks at once
        mesh = _flat_mesh(mesh)
        p_shard = tree_shardings(gnn_axes(arch), p_shapes,
                                 arch.param_rules, mesh)

    if shape.kind == "full":
        loss1 = gnn_single_loss(arch, remat=True)
        with fake_mode:
            batch = _gnn_full_batch_shapes(arch, shape, mesh)
        step = _raw_train_step(lambda p, b: loss1(T.bind(model, p), b), mdt)
        desc = f"full-graph train N={shape.n_nodes} E={shape.n_edges}"
    else:
        if shape.kind == "minibatch":
            ndev = math.prod(mesh.shape)
            n_graphs = ndev                       # one subgraph per device
            seeds = max(1, shape.batch_nodes // ndev)
            # nodes a seed reaches per hop: the fanouts' running products
            hop_sum = sum(math.prod(shape.fanout[:i + 1])
                          for i in range(len(shape.fanout)))
            mn = _round_up(seeds * (1 + hop_sum) + 8, 128)
            me = _round_up(seeds * hop_sum + 8, 128)
            spec_axes = _all_axes(mesh)
            with_labels = True
            desc = (f"minibatch G={n_graphs} seeds/shard={seeds} "
                    f"max_nodes={mn} max_edges={me}")
        else:  # molecule
            n_graphs = shape.batch
            mn, me = shape.max_nodes, shape.max_edges
            spec_axes = dp_axes(mesh)
            with_labels = False
            desc = f"molecule B={n_graphs} n={mn} e={me}"
        with fake_mode:
            batch = _gnn_graph_level_shapes(arch, n_graphs, mn, me, mesh,
                                            spec_axes, with_labels)
        step = _raw_train_step(
            _graph_level_loss(gnn_single_loss(arch, remat=False), model,
                              mesh, spec_axes), mdt)

    with fake_mode:
        state_in = _attach(train_state_shapes(p_shapes, mdt),
                           train_state_shardings(p_shard, mesh))
    return Cell(fn=step, args=(state_in, batch), fake_mode=fake_mode,
                out_bytes=_train_out_bytes(state_in),
                donated=tree_nbytes(state_in), static_desc=desc)


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------
def rec_cell(arch: ArchSpec, shape: RecShape, mesh, fake_mode) -> Cell:
    cfg: FM.FMConfig = arch.model_cfg
    mdt = _dtype(arch.moment_dtype)
    dp = dp_axes(mesh)
    model = FM.init_fm(cfg, device="meta")
    p_shapes = cast_float_leaves(T.reference_leaves(model),
                                 _dtype(arch.param_dtype))
    p_shard = tree_shardings(FM.fm_axes(cfg), p_shapes, arch.param_rules,
                             mesh)
    with fake_mode:
        params_in = _attach(p_shapes, p_shard)

    if shape.kind == "train":
        step = _raw_train_step(
            lambda p, b: FM.fm_loss(T.bind(model, p), cfg, b["ids"],
                                    b["labels"]), mdt,
            grad_dtype=_dtype(arch.grad_dtype) if arch.grad_dtype else None)
        with fake_mode:
            state_in = _attach(train_state_shapes(p_shapes, mdt),
                               train_state_shardings(p_shard, mesh))
            batch = {"ids": _sds((shape.batch, cfg.n_fields), torch.int32,
                                 mesh, (dp, None)),
                     "labels": _sds((shape.batch,), torch.float32, mesh,
                                    (dp,))}
        return Cell(fn=step, args=(state_in, batch), fake_mode=fake_mode,
                    out_bytes=_train_out_bytes(state_in),
                    donated=tree_nbytes(state_in),
                    static_desc=f"fm train B={shape.batch}")

    if shape.kind == "serve":
        dpn = dp_size(mesh)
        on_dp = shape.batch % dpn == 0
        with fake_mode:
            ids = _sds((shape.batch, cfg.n_fields), torch.int32, mesh,
                       (dp, None) if on_dp else (None, None))
        return Cell(fn=lambda p, i: FM.apply_fm(T.bind(model, p), cfg, i),
                    args=(params_in, ids), fake_mode=fake_mode,
                    out_bytes=(shape.batch // dpn if on_dp
                               else shape.batch) * 4,
                    static_desc=f"fm serve B={shape.batch}")

    # retrieval: 1 query vs n_candidates
    ndev = math.prod(mesh.shape)
    NC = _round_up(shape.n_candidates, ndev)
    fq, fc = 20, 19
    with fake_mode:
        q_in = _sds((fq,), torch.int32, mesh, (None,))
        c_in = _sds((NC, fc), torch.int32, mesh, (_all_axes(mesh), None))
    return Cell(fn=lambda p, q, c: FM.fm_retrieval_scores(
                    T.bind(model, p), cfg, q, c),
                args=(params_in, q_in, c_in), fake_mode=fake_mode,
                out_bytes=NC // ndev * 4,
                static_desc=f"fm retrieval NC={NC}")


def build_cell(arch: ArchSpec, shape_name: str, mesh, fake_mode) -> Cell:
    """The cell of ``arch`` at ``shape_name`` on ``mesh`` (a fake mesh in
    the dry run), its arguments made under ``fake_mode``."""
    if shape_name in arch.skip_shapes:
        raise ValueError(
            f"{arch.id} skips {shape_name}: {arch.skip_shapes[shape_name]}")
    shape = arch.shapes[shape_name]
    if arch.family == "lm":
        return lm_cell(arch, shape, mesh, fake_mode)
    if arch.family == "gnn":
        return gnn_cell(arch, shape, mesh, fake_mode)
    if arch.family == "recsys":
        return rec_cell(arch, shape, mesh, fake_mode)
    raise ValueError(arch.family)
