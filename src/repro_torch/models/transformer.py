"""Transformer LM, the port of ``repro/models/transformer.py``: GQA
(qk-norm optional) and MLA attention, sliding-window and local:global
patterns, dense SwiGLU or capacity-based MoE FFNs (shared experts, the
DeepSeek-V3 sigmoid router), the optional MTP head, tied or separate
embeddings; serving (:func:`prefill`, :func:`decode_step`) and training
(:func:`lm_loss`).

:class:`TransformerLM` is an ``nn.Module`` holding the parameters (one
``nn.ModuleList`` of blocks, dense layers first as the reference's
``layer_groups`` orders them, and the ``mtp`` head); the plain functions
run it, and :func:`make_cache` builds the per-layer caches (a rotating
window cache for each local layer, the compressed latent for MLA).  The
reference scans over stacked layers (``lax.scan``, its
``_uniform_cache`` choosing where); the port loops over its blocks in
Python for every config.  Remat (``forward(remat=True)``) runs each layer
under ``torch.utils.checkpoint``.  The reference's dry-run knobs are
here: :func:`set_act_spec` (the residual stream's DTensor layout),
``layers.set_unroll`` (a no-op: the port's loops are Python loops) and
``moe_spec``; :func:`lm_axes` and :func:`layer_axes` are its sharding
rules.

Training works on the reference's pytree layout: :func:`reference_leaves`
gives the parameters as ``{path: tensor}`` with each layer group stacked
on a leading axis (``"blocks/0/attn/wq"``), :func:`param_paths` is the map
from the port's parameter names to those paths, and :func:`bind` runs the
model on such leaves (autograd flows to them), so the optimizers,
checkpoints and gradients of ``repro_torch.train`` see the reference's
leaves one for one.

Device: :class:`TransformerLM`, :func:`init_lm` and :func:`make_cache`
put their tensors on the card unless the caller asks for the CPU
(``device="cpu"``); with no card the default is a
:class:`~repro_torch.errors.ConfigError`
(:func:`~repro_torch.core.bvss.resolve_device`).  The functions that run
a model run where its parameters are; :func:`prefill` and
:func:`decode_step` build no autograd graph.

Precision: in float32 mode (``compute_dtype=torch.float32``) the
functions run their matmuls with TF32 off (:func:`float32_matmuls`),
even where the caller turned it on for the process; bfloat16 mode leaves
the setting alone.  :func:`load_reference_params` fills a model from the
reference's ``init_lm`` pytree (as numpy arrays), so both packages
compute the same function.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.core.bvss import resolve_device
from repro_torch.distributed.sharding import flatten_axes
from repro_torch.errors import ConfigError
from repro_torch.models.layers import (GQA, MLA, MLP, LMConfig, MoE,
                                       _constrain, _zeros, apply_gqa,
                                       to_local,
                                       apply_mla, apply_mlp, apply_moe,
                                       dense_init, gqa_axes, mla_axes,
                                       mlp_axes, moe_axes, rms_norm,
                                       take_rows)

# The placements the embedding output is redistributed to when it is a
# DTensor (the reference's ``_ACT_SPEC``: with the embedding dim sharded
# over "data", DeepSeek's lookup output would otherwise inherit a
# d-sharded layout that fights the batch sharding).  The dry run's cells
# set it (``repro_torch.configs.families``); None changes nothing.
_ACT_SPEC = None


def set_act_spec(spec):
    """``spec``: None, a :class:`~repro_torch.distributed.sharding.
    Sharding`, or a tuple of DTensor placements."""
    global _ACT_SPEC
    _ACT_SPEC = getattr(spec, "placements", spec)


def _constrain_act(x):
    return _constrain(x, _ACT_SPEC)


def _embed(model, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``: ``embed[tokens]``, shard-locally
    on DTensors (:func:`~repro_torch.models.layers.take_rows`)."""
    if isinstance(model.embed, DTensor) or isinstance(tokens, DTensor):
        return take_rows(model.embed, tokens)
    return model.embed[tokens]


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    count: int
    is_moe: bool


def layer_groups(cfg: LMConfig) -> list[GroupSpec]:
    """Contiguous layers of one structure (the reference stacks each
    group's parameters on a leading layer axis)."""
    if cfg.is_moe and cfg.n_dense_layers > 0:
        return [GroupSpec(cfg.n_dense_layers, False),
                GroupSpec(cfg.n_layers - cfg.n_dense_layers, True)]
    return [GroupSpec(cfg.n_layers, cfg.is_moe)]


def _window_code(cfg: LMConfig, layer: int) -> int:
    w = cfg.layer_window(layer)
    return 0 if w is None else w  # 0 = global


@contextlib.contextmanager
def float32_matmuls(compute_dtype: torch.dtype):
    """Turn TF32 off for CUDA matmuls while open when computing in
    float32 (TF32 rounds the operands to 10 mantissa bits); a no-op
    otherwise.  The flag is process-wide, so it is written only where
    the caller turned it on (PyTorch's default is off), and put back on
    leaving."""
    if compute_dtype != torch.float32 or \
            not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """One layer (the reference's ``init_layer``): ``attn``
    (:class:`~repro_torch.models.layers.MLA` or
    :class:`~repro_torch.models.layers.GQA`), ``ffn``
    (:class:`~repro_torch.models.layers.MoE` in the MoE group, else an
    :class:`~repro_torch.models.layers.MLP` of ``dense_d_ff`` in an MoE
    config that sets it, of ``d_ff`` otherwise), ``ln1``, ``ln2``."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device,
                 is_moe: bool = False):
        super().__init__()
        self.attn = (MLA if cfg.attn == "mla" else GQA)(cfg, generator,
                                                        device)
        if is_moe:
            self.ffn = MoE(cfg, generator, device)
        else:
            d_ff = cfg.dense_d_ff if (cfg.is_moe and cfg.dense_d_ff) \
                else cfg.d_ff
            self.ffn = MLP(cfg.d_model, d_ff, generator, device)
        self.ln1 = _zeros(cfg.d_model, device)
        self.ln2 = _zeros(cfg.d_model, device)


def layer_axes(cfg: LMConfig, is_moe: bool) -> dict:
    """One layer's logical axes, a nested dict (the reference's
    ``layer_axes``)."""
    attn = mla_axes(cfg) if cfg.attn == "mla" else gqa_axes(cfg)
    ffn = moe_axes(cfg) if is_moe else mlp_axes()
    return {"attn": attn, "ffn": ffn, "ln1": (None,), "ln2": (None,)}


def apply_layer(p: Block, cfg: LMConfig, x, q_pos, window, *,
                kv_cache=None, moe_groups: int = 1,
                capture_kv: bool = False, moe_spec: tuple | None = None):
    attn_fn = apply_mla if isinstance(p.attn, MLA) else apply_gqa
    # the residual stream keeps the activation layout (a DTensor's
    # partial sums are reduced here, not scattered over the sequence)
    x = _constrain_act(x)
    h, new_cache = attn_fn(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                           q_pos, window=window, kv_cache=kv_cache,
                           capture_kv=capture_kv)
    x = _constrain_act(x + h)
    z = rms_norm(x, p.ln2, cfg.norm_eps)
    if isinstance(p.ffn, MoE):
        return x + apply_moe(p.ffn, cfg, z, n_groups=moe_groups,
                             moe_spec=moe_spec), new_cache
    return x + apply_mlp(p.ffn, z), new_cache


def _remat_layer(p: Block, cfg: LMConfig, x, q_pos, window,
                 moe_groups: int, moe_spec: tuple | None = None):
    """One layer under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): only its input is kept for the backward pass,
    which runs the layer again."""
    return checkpoint(
        lambda x_: apply_layer(p, cfg, x_, q_pos, window,
                               moe_groups=moe_groups, moe_spec=moe_spec)[0],
        x, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
class MTP(nn.Module):
    """DeepSeek-V3's multi-token-prediction head: ``proj`` (2d, d),
    ``norm_h``, ``norm_e`` and a dense :class:`Block`."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        d = cfg.d_model
        self.proj = nn.Parameter(dense_init(generator, (2 * d, d), 2 * d,
                                            device))
        self.norm_h = _zeros(d, device)
        self.norm_e = _zeros(d, device)
        self.block = Block(cfg, generator, device, is_moe=False)


class TransformerLM(nn.Module):
    """An LM's parameters: ``embed`` (V, d), ``final_norm`` (d,),
    ``head`` (d, V) unless the embeddings are tied, ``blocks``, one
    :class:`Block` a layer in :func:`layer_groups`' order, and ``mtp``
    (:class:`MTP`) with ``cfg.mtp``; drawn from ``generator``, which lives
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = model_device(generator, device)
        self.cfg = cfg
        self.embed = nn.Parameter(dense_init(
            generator, (cfg.vocab, cfg.d_model), cfg.d_model, device))
        self.final_norm = _zeros(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(dense_init(
                generator, (cfg.d_model, cfg.vocab), cfg.d_model, device))
        self.blocks = nn.ModuleList(
            Block(cfg, generator, device, grp.is_moe)
            for grp in layer_groups(cfg) for _ in range(grp.count))
        if cfg.mtp:
            self.mtp = MTP(cfg, generator, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head_weight(self) -> torch.Tensor:
        """(d, V): the tied embedding's transpose or the separate head.
        A DTensor embedding's transpose is made contiguous: DTensor's
        einsum backward views its local gradient, which a transposed
        local block cannot give."""
        if not self.cfg.tie_embeddings:
            return self.head
        head = self.embed.T
        return head.contiguous() if isinstance(head, DTensor) else head


def init_lm(cfg: LMConfig, generator: torch.Generator | None = None,
            device=None) -> TransformerLM:
    """A model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU; with no card the default raises
    :class:`~repro_torch.errors.ConfigError`), its weights drawn from
    ``generator`` (a fresh seed-0 generator on that device when None)."""
    return TransformerLM(cfg, *init_generator(generator, device))


def model_device(generator: torch.Generator, device) -> torch.device:
    """The device a model's constructor draws its weights on: ``device``
    (the card when None; no card is a
    :class:`~repro_torch.errors.ConfigError`), which must be
    ``generator``'s."""
    device = _resolve_model_device(device)
    if device.type == "meta":
        return device
    if generator.device.type != device.type:
        raise ConfigError(
            f"the generator is on {generator.device}, the model on "
            f"{device}: draw the weights from a generator on the "
            f"model's device")
    return device


def init_generator(generator: torch.Generator | None, device
                   ) -> tuple[torch.Generator, torch.device]:
    """An ``init_*`` entry point's (generator, device): the card unless
    the caller asks for the CPU, and a fresh seed-0 generator there when
    ``generator`` is None."""
    device = _resolve_model_device(device)
    if generator is None:
        generator = torch.Generator(
            device="cpu" if device.type == "meta" else device).manual_seed(0)
    return generator, device


def _resolve_model_device(device) -> torch.device:
    """:func:`~repro_torch.core.bvss.resolve_device`, and ``"meta"``: a
    model of shapes alone (the dry run's), whose weights are drawn from
    nothing and allocate nothing."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _view(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s tree of modules that shares its tensors:
    replacing a parameter or attribute of the copy leaves ``module`` as
    it is."""
    new = copy.copy(module)
    new.__dict__["_parameters"] = dict(module._parameters)
    new.__dict__["_modules"] = {name: _view(child)
                                for name, child in module._modules.items()}
    return new


def with_capacity_factor(model: TransformerLM, factor: float
                         ) -> TransformerLM:
    """A view of an MoE ``model`` that shares its parameters and routes
    with ``capacity_factor`` ``factor`` (the reference passes ``cfg``
    beside its params; the port binds it to the model).  At ``factor``
    ≥ E / K every expert's buffer holds the whole group, so nothing is
    dropped."""
    cfg = model.cfg
    if not cfg.is_moe:
        raise ConfigError(f"{cfg.name!r} has no MoE layer")
    view = _view(model)
    view.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    return view


def forward(model: TransformerLM, tokens: torch.Tensor, *,
            compute_dtype=torch.bfloat16, moe_groups: int = 1,
            remat: bool = True, skip_logits: bool = False,
            moe_spec: tuple | None = None):
    """tokens (B, S) int -> (logits (B, S, V) float32 | None, h).  With
    ``remat`` (and autograd recording) each layer runs under
    ``torch.utils.checkpoint``.  ``moe_spec`` goes to every MoE layer
    (:func:`~repro_torch.models.layers.apply_moe`)."""
    cfg = model.cfg
    B, S = tokens.shape
    remat = remat and torch.is_grad_enabled()
    with float32_matmuls(compute_dtype):
        x = _constrain_act(_embed(model, tokens).to(compute_dtype))
        q_pos = torch.arange(S, device=x.device).expand(B, S)
        for layer, blk in enumerate(model.blocks):
            win = _window_code(cfg, layer)
            if remat:
                x = _remat_layer(blk, cfg, x, q_pos, win, moe_groups,
                                 moe_spec)
            else:
                x, _ = apply_layer(blk, cfg, x, q_pos, win,
                                   moe_groups=moe_groups, moe_spec=moe_spec)
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        if skip_logits:
            return None, x
        logits = torch.einsum("bsd,dv->bsv", x,
                              model.head_weight().to(compute_dtype))
    return logits.float(), x


def mtp_hidden(model: TransformerLM, h: torch.Tensor, tokens: torch.Tensor,
               *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """DeepSeek-V3's MTP trunk: hidden states predicting token t+2 from
    the backbone's state at t and the embedding of token t+1.  Returns
    (B, S-1, d), final-normed; the shared head and the streaming
    cross-entropy make the logits."""
    cfg, mp = model.cfg, model.mtp
    B, S, _ = h.shape
    with float32_matmuls(compute_dtype):
        h_in = rms_norm(_constrain_act(h[:, :-1]), mp.norm_h, cfg.norm_eps)
        e_in = rms_norm(_constrain_act(
            _embed(model, tokens[:, 1:]).to(compute_dtype)),
            mp.norm_e, cfg.norm_eps)
        z = _constrain_act(torch.einsum(
            "bsd,dk->bsk", torch.cat([h_in, e_in], dim=-1),
            mp.proj.to(compute_dtype)))
        q_pos = torch.arange(S - 1, device=h.device).expand(B, S - 1)
        z, _ = apply_layer(mp.block, cfg, z, q_pos, 0)
        return rms_norm(z, model.final_norm, cfg.norm_eps)


CE_CHUNK = 512  # sequence-chunk size for streaming cross-entropy


def _chunked_nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                 chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean next-token NLL without keeping (B, S, V) logits: the head
    matmul, log-softmax and gather run per sequence chunk under
    ``torch.utils.checkpoint``, so peak memory is one chunk's logits."""
    B, S, _ = x.shape

    def one(xc, tc):
        logits = torch.einsum("bsd,dv->bsv", xc, head).float()
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.take_along_dim(lp, tc[..., None], dim=-1).sum()

    def run(xc, tc):
        # a DTensor chunk keeps the activation layout, its gradient too
        xc = _constrain_act(xc)
        if not torch.is_grad_enabled():
            return one(xc, tc)
        return checkpoint(one, xc, tc, use_reentrant=False,
                          preserve_rng_state=False)

    if S <= chunk:
        return run(x, targets) / (B * S)
    main = S // chunk * chunk
    total = torch.stack([run(x[:, i:i + chunk], targets[:, i:i + chunk])
                         for i in range(0, main, chunk)]).sum()
    if S > main:  # the remainder chunk (e.g. the MTP trunk's S-2 positions)
        total = total + run(x[:, main:], targets[:, main:])
    return total / (B * S)


def lm_loss(model: TransformerLM, tokens: torch.Tensor, *,
            compute_dtype=torch.bfloat16, moe_groups: int = 1,
            remat: bool = True, mtp_weight: float = 0.3,
            moe_spec: tuple | None = None) -> torch.Tensor:
    """Next-token cross-entropy (plus ``mtp_weight`` times the MTP head's
    t+2 cross-entropy with ``cfg.mtp``), streaming over sequence chunks
    so full-vocabulary logits never stay in memory."""
    cfg = model.cfg
    with float32_matmuls(compute_dtype):
        _, h = forward(model, tokens, compute_dtype=compute_dtype,
                       moe_groups=moe_groups, remat=remat, skip_logits=True,
                       moe_spec=moe_spec)
        head = model.head_weight().to(compute_dtype)
        loss = _chunked_nll(h[:, :-1], head, tokens[:, 1:])
        if cfg.mtp:
            hm = mtp_hidden(model, h, tokens, compute_dtype=compute_dtype)
            loss = loss + mtp_weight * _chunked_nll(hm[:, :-1], head,
                                                    tokens[:, 2:])
    return loss


# ---------------------------------------------------------------------------
# serving: heterogeneous per-layer caches
# ---------------------------------------------------------------------------
def make_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> list[dict]:
    """One cache dict per layer, on ``device`` (the card unless the caller
    asks for the CPU): ``k``/``v`` (B, L, Hkv, Dh) for GQA, the latent
    ``c_kv`` (B, L, kv_lora) and ``k_rope`` (B, L, 1, qk_rope) for MLA;
    local layers get a rotating window cache of ``min(max_len, window)``
    slots.  ``device="meta"`` gives the shapes alone."""
    device = _resolve_model_device(device)
    caches = []
    for layer in range(cfg.n_layers):
        w = cfg.layer_window(layer)
        L = max_len if w is None else min(max_len, w)
        if cfg.attn == "mla":
            shapes = {"c_kv": (batch, L, cfg.kv_lora_rank),
                      "k_rope": (batch, L, 1, cfg.qk_rope_dim)}
        else:
            kv = (batch, L, cfg.n_kv_heads, cfg.d_head)
            shapes = {"k": kv, "v": kv}
        caches.append({name: torch.zeros(shape, dtype=dtype, device=device)
                       for name, shape in shapes.items()})
    return caches


def _slot_positions(pos: torch.Tensor, L: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute position stored in each rotating slot, per example:
    pos (B,) -> k_pos (B, L) where slot i holds p = pos - ((pos - i) mod L),
    and whether that slot holds a position yet (p >= 0)."""
    i = torch.arange(L, device=pos.device)[None, :]
    p = pos[:, None] - torch.remainder(pos[:, None] - i, L)
    return p, p >= 0


def _cache_names(cache: dict) -> tuple[str, str]:
    """The payload's names in the order the attention returns them."""
    return ("c_kv", "k_rope") if "c_kv" in cache else ("k", "v")


def cache_len(cache: dict) -> int:
    return cache[_cache_names(cache)[0]].shape[1]


def _put_slots(cache: DTensor, wi, val) -> DTensor:
    """``cache`` (B, L, ...) with row ``wi[b]`` of example ``b`` set to
    ``val[b]``, in a new DTensor, shard-locally: each rank writes the
    rows of its own examples (a batch split) that fall in its own slots
    (a split of the length)."""
    mesh = cache.device_mesh
    pl = cache.placements
    n = mesh.ndim
    batch = tuple(Shard(0) if p == Shard(0) else Replicate()
                  for p in pl)
    # val lacks the length dim: a split of dim d > 1 is dim d - 1 there
    val_pl = tuple(Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else
                   batch[i] for i, p in enumerate(pl))
    c_l = cache.to_local()
    v_l = to_local(val, val_pl, mesh)
    w_l = to_local(wi, batch, mesh)
    block = 0
    for i in range(n):
        if pl[i] == Shard(1):
            block = block * mesh.shape[i] + mesh.get_coordinate()[i]
    slot = w_l - block * c_l.shape[1]
    hit = (slot >= 0) & (slot < c_l.shape[1])
    slot = torch.where(hit, slot, 0)
    b_l = torch.arange(c_l.shape[0], device=c_l.device)
    keep = c_l[b_l, slot]
    mask = hit.reshape(-1, *([1] * (keep.dim() - 1)))
    upd = c_l.index_put((b_l, slot), torch.where(mask, v_l, keep))
    return DTensor.from_local(upd, mesh, pl, run_check=False,
                              shape=cache.shape, stride=cache.stride())


def _cache_cb(cache: dict, pos: torch.Tensor, batch: int):
    """pos (B,): per-slot decode positions (continuous batching).  The
    callback writes the new payload at each example's slot ``pos % L`` of
    NEW tensors (the given cache is never written)."""
    L = cache_len(cache)
    wi = torch.remainder(pos, L)
    b_idx = torch.arange(batch, device=pos.device)

    def cb(*new):
        new_cache = {}
        outs = []
        for name, arr in zip(_cache_names(cache), new):
            val = arr[:, 0].to(cache[name].dtype)
            upd = _put_slots(cache[name], wi, val) \
                if isinstance(cache[name], DTensor) else \
                cache[name].index_put((b_idx, wi), val)
            new_cache[name] = upd
            outs.append(upd)
        k_pos, valid = _slot_positions(pos, L)
        return (*outs, k_pos, valid, new_cache)

    return cb


@torch.no_grad()
def decode_step(model: TransformerLM, caches: list[dict],
                tokens: torch.Tensor, pos, *, compute_dtype=torch.bfloat16):
    """One decode step: tokens (B, 1), ``pos`` an int or (B,) ints (the
    0-based position of each slot's new token — per-slot positions enable
    continuous batching).  The MoE layers route the B tokens as one
    group.  Returns (logits (B, V) float32, new caches)."""
    cfg = model.cfg
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int64)
    pos = pos.expand(B) if pos.dim() == 0 else pos
    new_caches = []
    with float32_matmuls(compute_dtype):
        x = _embed(model, tokens).to(compute_dtype)
        q_pos = pos[:, None]
        for layer, blk in enumerate(model.blocks):
            cb = _cache_cb(caches[layer], pos, B)
            x, nc = apply_layer(blk, cfg, x, q_pos, _window_code(cfg, layer),
                                kv_cache=cb)
            new_caches.append(nc)
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x,
                              model.head_weight().to(compute_dtype))
    return logits[:, 0].float(), new_caches


@torch.no_grad()
def prefill(model: TransformerLM, tokens: torch.Tensor, *, max_len: int = 0,
            compute_dtype=torch.bfloat16, moe_groups: int = 1):
    """Run the prompt through the model once, capturing per-layer caches
    (full attention over the prompt; only each layer's cache-length tail
    is kept, in rotating-slot order).  ``max_len`` (>= S) sizes the caches
    for the decode steps after it.  Returns (last-position logits (B, V),
    caches)."""
    cfg = model.cfg
    B, S = tokens.shape
    max_len = max(max_len, S)
    caches = make_cache(cfg, B, max_len, dtype=compute_dtype,
                        device=tokens.device)
    new_caches = []
    with float32_matmuls(compute_dtype):
        x = _embed(model, tokens).to(compute_dtype)
        q_pos = torch.arange(S, device=x.device).expand(B, S)
        for layer, blk in enumerate(model.blocks):
            x, kv = apply_layer(blk, cfg, x, q_pos, _window_code(cfg, layer),
                                capture_kv=True, moe_groups=moe_groups)
            new_caches.append(_fill_cache(caches[layer], kv, S))
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x[:, -1:],
                              model.head_weight().to(compute_dtype))
    return logits[:, 0].float(), new_caches


def _fill_cache(cache: dict, kv: tuple, S: int) -> dict:
    """Write the last min(S, L) prompt positions into rotating-slot order
    (slot of absolute position p is p % L), in new tensors: the tail
    rolled into place when it fills the cache, else the tail then the
    cache's slots past it (position p < S < L sits at slot p)."""
    L = cache_len(cache)
    T = min(S, L)
    start = S - T
    out = {}
    for name, arr in zip(_cache_names(cache), kv):
        tail = arr[:, -T:].to(cache[name].dtype)
        if T < L:
            tail = torch.cat([tail, cache[name][:, T:]], dim=1)
        out[name] = torch.roll(tail, shifts=start % L, dims=1) \
            if start % L else tail
    return out


# ---------------------------------------------------------------------------
# the reference's pytree layout
# ---------------------------------------------------------------------------
def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: tree}


def reference_paths(tree) -> dict[str, object]:
    """A nested pytree of dicts and lists (the reference's ``init_lm``
    params or grads) as ``{"/"-joined path: leaf}``."""
    return {"/".join(map(str, path)): leaf
            for path, leaf in _flatten(tree).items()}


def param_paths(model: nn.Module) -> dict[str, tuple[str, int | None]]:
    """Each parameter name of the port (``blocks.3.attn.wq``) -> its
    reference pytree path (``blocks/1/attn/wq`` when layer 3 is the
    second of group 1) and its index on that group's leading layer axis,
    None outside the blocks (``embed``, ``mtp/block/attn/wq``, ...).  A
    model with no stacked layer groups (the GNN and recsys models of
    ``repro_torch.models``, whose reference pytrees keep a list of layer
    dicts) maps each name to itself, ``/`` for ``.``
    (``layers.0.mlp.w1`` -> ``layers/0/mlp/w1``)."""
    in_group = []
    if isinstance(model, TransformerLM):
        for gi, grp in enumerate(layer_groups(model.cfg)):
            in_group += [(gi, i) for i in range(grp.count)]
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if in_group and parts[0] == "blocks":
            gi, i = in_group[int(parts[1])]
            out[name] = ("/".join(["blocks", str(gi), *parts[2:]]), i)
        else:
            out[name] = ("/".join(parts), None)
    return out


def _leaf_shapes(model: nn.Module) -> dict[str, tuple]:
    """Each reference path's leaf shape (with its group's layer axis)."""
    params = dict(model.named_parameters())
    shapes: dict[str, tuple] = {}
    counts: dict[str, int] = {}
    for name, (path, i) in param_paths(model).items():
        shapes[path] = tuple(params[name].shape)
        if i is not None:
            counts[path] = counts.get(path, 0) + 1
    return {path: ((counts[path],) if path in counts else ()) + shape
            for path, shape in shapes.items()}


def reference_leaves(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters in the reference's pytree layout, as new
    tensors: ``{path: tensor}``, each layer group's leaves stacked on a
    leading layer axis."""
    paths = param_paths(model)
    groups: dict[str, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(paths[name][0], []).append((paths[name][1], p))
    with torch.no_grad():
        return {path: ps[0][1].detach().clone() if ps[0][0] is None
                else torch.stack([p.detach() for _, p in ps])
                for path, ps in groups.items()}


def lm_axes(cfg: LMConfig) -> dict[str, tuple]:
    """Every leaf's logical axes, ``{path: axes}`` over
    :func:`reference_leaves`' paths (the reference's ``lm_axes``, each
    layer group's leaves led by ``"layers"``)."""
    tree: dict = {"embed": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        tree["head"] = ("embed", "vocab")
    tree["blocks"] = [
        {k: ("layers",) + v
         for k, v in flatten_axes(layer_axes(cfg, grp.is_moe)).items()}
        for grp in layer_groups(cfg)]
    if cfg.mtp:
        tree["mtp"] = {"proj": ("embed", None), "norm_h": (None,),
                       "norm_e": (None,), "block": layer_axes(cfg, False)}
    return flatten_axes(tree)


def bind(model: nn.Module, leaves: dict[str, torch.Tensor]) -> nn.Module:
    """A view of ``model`` whose parameters are ``leaves`` (the reference's
    layout, :func:`reference_leaves`), each stacked leaf cut into its
    layers; autograd through the view reaches ``leaves``.  ``model``
    itself is left as it is."""
    paths = param_paths(model)
    want = {path for path, _ in paths.values()}
    if set(leaves) != want:
        raise ConfigError(
            f"leaves do not match the {model.cfg.name!r} model: missing "
            f"{sorted(want - set(leaves))}, extra {sorted(set(leaves) - want)}")
    layers = {}
    view = _view(model)
    for name, (path, i) in paths.items():
        owner, _, attr = name.rpartition(".")
        if i is None:
            t = leaves[path]
        else:
            if path not in layers:
                layers[path] = leaves[path].unbind(0)
            t = layers[path][i]
        # a plain tensor where a parameter was, as torch.func does
        view.get_submodule(owner)._parameters[attr] = t
    return view


def load_reference_params(model: nn.Module, tree) -> nn.Module:
    """Fill ``model`` from the reference's init pytree given as numpy
    arrays (``init_lm``'s, or a GNN or recsys model's ``init_*``): for an
    LM ``embed``, ``final_norm``, the optional ``head``, ``blocks[g]``
    (stacked on a leading layer axis), unstacked onto the port's blocks,
    and the optional ``mtp`` subtree; for another model each leaf at its
    :func:`param_paths` path.  Every leaf must match the model's shape and
    dtype exactly; a missing or extra leaf raises
    :class:`~repro_torch.errors.ConfigError`.  Returns ``model``."""
    cfg = model.cfg
    got = reference_paths(tree)
    shapes = _leaf_shapes(model)
    missing = sorted(set(shapes) - set(got))
    extra = sorted(set(got) - set(shapes))
    if missing or extra:
        raise ConfigError(
            f"reference params do not match the {cfg.name!r} model: "
            f"missing {missing}, extra {extra}")
    params = dict(model.named_parameters())
    dtypes = {path: params[name].dtype
              for name, (path, _) in param_paths(model).items()}
    for path, shape in shapes.items():
        arr = np.asarray(got[path])
        if arr.shape != shape or torch.from_numpy(
                np.zeros(0, arr.dtype)).dtype != dtypes[path]:
            raise ConfigError(
                f"reference param {path} is {arr.dtype}{arr.shape}, "
                f"the model's is {dtypes[path]}{shape}")
    host = {path: torch.from_numpy(np.array(got[path]))  # writable copies
            for path in shapes}
    with torch.no_grad():
        for name, (path, i) in param_paths(model).items():
            params[name].copy_(host[path] if i is None else host[path][i])
    return model
