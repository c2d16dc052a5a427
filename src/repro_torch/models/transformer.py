"""Transformer LM, the serving half of ``repro/models/transformer.py``:
the dense GQA configurations (qk-norm optional, sliding-window and
local:global attention, SwiGLU FFN, tied or separate head).

:class:`TransformerLM` is an ``nn.Module`` holding the parameters (one
``nn.ModuleList`` of blocks); the plain functions :func:`forward`,
:func:`prefill` and :func:`decode_step` run it, and :func:`make_cache`
builds the per-layer KV caches (a rotating window cache for each local
layer).  The reference scans over stacked layers (``lax.scan``, its
``_uniform_cache`` choosing where); the port loops over its blocks in
Python for every config, and leaves out the reference's
training and dry-run knobs (``jax.checkpoint`` remat, ``set_act_spec``,
``set_unroll``; ROADMAP.md §3 E).  ``lm_loss``, ``_chunked_nll`` and
``mtp_hidden`` belong to training (ROADMAP.md queue 1 item 13c); MLA,
MoE and MTP configurations raise :class:`~repro_torch.errors.ConfigError`
(item 13b).

Device: :class:`TransformerLM`, :func:`init_lm` and :func:`make_cache`
put their tensors on the card unless the caller asks for the CPU
(``device="cpu"``); with no card the default is a
:class:`~repro_torch.errors.ConfigError`
(:func:`~repro_torch.core.bvss.resolve_device`).  The functions that run
a model run where its parameters are.

Precision: in float32 mode (``compute_dtype=torch.float32``) the
functions run their matmuls with TF32 off (:func:`float32_matmuls`),
even where the caller turned it on for the process; bfloat16 mode leaves
the setting alone.  :func:`load_reference_params` fills a model from the
reference's ``init_lm`` pytree (as numpy arrays), so both packages
compute the same function.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.bvss import resolve_device
from repro_torch.errors import ConfigError
from repro_torch.models.layers import (GQA, MLP, LMConfig, apply_gqa,
                                       apply_mlp, dense_init, rms_norm)


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


def check_ported(cfg: LMConfig) -> None:
    """Refuse the configurations of ROADMAP.md queue 1 item 13b."""
    what = [name for name, on in (("attn='mla'", cfg.attn == "mla"),
                                  ("moe", cfg.is_moe), ("mtp", cfg.mtp))
            if on]
    if what:
        raise ConfigError(
            f"LM config {cfg.name!r} uses {', '.join(what)}: MLA, MoE and "
            f"MTP are not ported to PyTorch yet (ROADMAP.md queue 1 item "
            f"13b); the dense GQA configurations are")


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
    (:class:`~repro_torch.models.layers.GQA`), ``ffn``
    (:class:`~repro_torch.models.layers.MLP`), ``ln1``, ``ln2``."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        self.attn = GQA(cfg, generator, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, generator, device)
        self.ln1 = nn.Parameter(torch.zeros(cfg.d_model, device=device),
                                requires_grad=False)
        self.ln2 = nn.Parameter(torch.zeros(cfg.d_model, device=device),
                                requires_grad=False)


def apply_layer(p: Block, cfg: LMConfig, x, q_pos, window, *,
                kv_cache=None, capture_kv: bool = False):
    h, new_cache = apply_gqa(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                             q_pos, window=window, kv_cache=kv_cache,
                             capture_kv=capture_kv)
    x = x + h
    z = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + apply_mlp(p.ffn, z), new_cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
class TransformerLM(nn.Module):
    """A dense GQA LM's parameters: ``embed`` (V, d), ``final_norm`` (d,),
    ``head`` (d, V) unless the embeddings are tied, and ``blocks``, one
    :class:`Block` a layer; drawn from ``generator``, which lives on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ConfigError(
                f"the generator is on {generator.device}, the model on "
                f"{device}: draw the weights from a generator on the "
                f"model's device")
        self.cfg = cfg
        self.embed = nn.Parameter(dense_init(
            generator, (cfg.vocab, cfg.d_model), cfg.d_model, device),
            requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.zeros(cfg.d_model, device=device), requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(dense_init(
                generator, (cfg.d_model, cfg.vocab), cfg.d_model, device),
                requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, generator, device) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head_weight(self) -> torch.Tensor:
        """(d, V): the tied embedding's transpose or the separate head."""
        return self.embed.T if self.cfg.tie_embeddings else self.head


def init_lm(cfg: LMConfig, generator: torch.Generator | None = None,
            device=None) -> TransformerLM:
    """A model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU; with no card the default raises
    :class:`~repro_torch.errors.ConfigError`), its weights drawn from
    ``generator`` (a fresh seed-0 generator on that device when None)."""
    check_ported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return TransformerLM(cfg, generator, device)


def forward(model: TransformerLM, tokens: torch.Tensor, *,
            compute_dtype=torch.bfloat16, skip_logits: bool = False):
    """tokens (B, S) int -> (logits (B, S, V) float32 | None, h)."""
    cfg = model.cfg
    B, S = tokens.shape
    with float32_matmuls(compute_dtype):
        x = model.embed[tokens].to(compute_dtype)
        q_pos = torch.arange(S, device=x.device).expand(B, S)
        for layer, blk in enumerate(model.blocks):
            x, _ = apply_layer(blk, cfg, x, q_pos, _window_code(cfg, layer))
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        if skip_logits:
            return None, x
        logits = torch.einsum("bsd,dv->bsv", x,
                              model.head_weight().to(compute_dtype))
    return logits.float(), x


# ---------------------------------------------------------------------------
# serving: heterogeneous per-layer KV caches
# ---------------------------------------------------------------------------
def make_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> list[dict]:
    """One cache dict per layer, on ``device`` (the card unless the caller
    asks for the CPU); local layers get a rotating window cache of
    ``min(max_len, window)`` slots."""
    check_ported(cfg)
    device = resolve_device(device)
    caches = []
    for layer in range(cfg.n_layers):
        w = cfg.layer_window(layer)
        L = max_len if w is None else min(max_len, w)
        shape = (batch, L, cfg.n_kv_heads, cfg.d_head)
        caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)})
    return caches


def _slot_positions(pos: torch.Tensor, L: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute position stored in each rotating slot, per example:
    pos (B,) -> k_pos (B, L) where slot i holds p = pos - ((pos - i) mod L),
    and whether that slot holds a position yet (p >= 0)."""
    i = torch.arange(L, device=pos.device)[None, :]
    p = pos[:, None] - torch.remainder(pos[:, None] - i, L)
    return p, p >= 0


def cache_len(cache: dict) -> int:
    return cache["k"].shape[1]


def _cache_cb(cache: dict, pos: torch.Tensor, batch: int):
    """pos (B,): per-slot decode positions (continuous batching).  The
    callback writes the new (k, v) at each example's slot ``pos % L`` of
    NEW tensors (the given cache is never written)."""
    L = cache_len(cache)
    wi = torch.remainder(pos, L)
    b_idx = torch.arange(batch, device=pos.device)

    def cb(*new):
        new_cache = {}
        outs = []
        for name, arr in zip(("k", "v"), new):
            upd = cache[name].index_put(
                (b_idx, wi), arr[:, 0].to(cache[name].dtype))
            new_cache[name] = upd
            outs.append(upd)
        k_pos, valid = _slot_positions(pos, L)
        return (*outs, k_pos, valid, new_cache)

    return cb


def decode_step(model: TransformerLM, caches: list[dict],
                tokens: torch.Tensor, pos, *, compute_dtype=torch.bfloat16):
    """One decode step: tokens (B, 1), ``pos`` an int or (B,) ints (the
    0-based position of each slot's new token — per-slot positions enable
    continuous batching).  Returns (logits (B, V) float32, new caches)."""
    cfg = model.cfg
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int64)
    pos = pos.expand(B) if pos.dim() == 0 else pos
    new_caches = []
    with float32_matmuls(compute_dtype):
        x = model.embed[tokens].to(compute_dtype)
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


def prefill(model: TransformerLM, tokens: torch.Tensor, *, max_len: int = 0,
            compute_dtype=torch.bfloat16):
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
        x = model.embed[tokens].to(compute_dtype)
        q_pos = torch.arange(S, device=x.device).expand(B, S)
        for layer, blk in enumerate(model.blocks):
            x, kv = apply_layer(blk, cfg, x, q_pos, _window_code(cfg, layer),
                                capture_kv=True)
            new_caches.append(_fill_cache(caches[layer], kv, S))
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x[:, -1:],
                              model.head_weight().to(compute_dtype))
    return logits[:, 0].float(), new_caches


def _fill_cache(cache: dict, kv: tuple, S: int) -> dict:
    """Write the last min(S, L) prompt positions into rotating-slot order
    (slot of absolute position p is p % L), in new tensors."""
    L = cache_len(cache)
    T = min(S, L)
    start = S - T
    slots = torch.remainder(start + torch.arange(T, device=kv[0].device), L)
    out = {}
    for name, arr in zip(("k", "v"), kv):
        upd = cache[name].clone()
        upd[:, slots] = arr[:, -T:].to(upd.dtype)
        out[name] = upd
    return out


# ---------------------------------------------------------------------------
# the reference's weights
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


def load_reference_params(model: TransformerLM, tree) -> TransformerLM:
    """Fill ``model`` from the reference's ``init_lm`` pytree given as
    numpy arrays: ``embed``, ``final_norm``, the optional ``head``, and
    ``blocks[g]`` (stacked on a leading layer axis), unstacked onto the
    port's blocks.  Every leaf must match the model's shape and dtype
    exactly; a missing or extra leaf raises
    :class:`~repro_torch.errors.ConfigError`.  Returns ``model``."""
    cfg = model.cfg
    want: dict = {("embed",): (model.embed, None),
                  ("final_norm",): (model.final_norm, None)}
    if not cfg.tie_embeddings:
        want[("head",)] = (model.head, None)
    layer0 = 0
    for gi, grp in enumerate(layer_groups(cfg)):
        names = {name for blk in model.blocks[layer0:layer0 + grp.count]
                 for name, _ in blk.named_parameters()}
        for name in sorted(names):
            path = ("blocks", gi) + tuple(name.split("."))
            want[path] = ([model.blocks[layer0 + i].get_parameter(name)
                           for i in range(grp.count)], grp.count)
        layer0 += grp.count
    got = _flatten(tree)
    missing = sorted(set(want) - set(got), key=str)
    extra = sorted(set(got) - set(want), key=str)
    if missing or extra:
        raise ConfigError(
            f"reference params do not match the {cfg.name!r} model: "
            f"missing {['/'.join(map(str, p)) for p in missing]}, "
            f"extra {['/'.join(map(str, p)) for p in extra]}")
    with torch.no_grad():
        for path, (dst, count) in want.items():
            arr = np.asarray(got[path])
            name = "/".join(map(str, path))
            shape = tuple(dst.shape) if count is None else \
                (count,) + tuple(dst[0].shape)
            dtype = (dst if count is None else dst[0]).dtype
            if arr.shape != shape or torch.from_numpy(
                    np.zeros(0, arr.dtype)).dtype != dtype:
                raise ConfigError(
                    f"reference param {name} is {arr.dtype}{arr.shape}, "
                    f"the model's is {dtype}{shape}")
            t = torch.from_numpy(np.array(arr))     # a writable copy
            if count is None:
                dst.copy_(t)
            else:
                for i, p in enumerate(dst):
                    p.copy_(t[i])
    return model
