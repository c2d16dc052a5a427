"""Transformer building blocks of the LM serving tier, the port of the
serving half of ``repro/models/layers.py``: RMSNorm, RoPE, GQA attention
(optional qk-norm, sliding window, causal and slot-validity masks) and the
SwiGLU MLP, as ``nn.Module``s with plain functions beside them.

The reference's attention is plain ``einsum`` and softmax, not a Pallas
kernel, and so is the port's: this module owes no hand kernel.  MLA and
the capacity-based MoE (the reference's ``init_mla``/``apply_mla``,
``init_moe``/``apply_moe``) are ROADMAP.md queue 1 item 13b; a model
whose config asks for them raises :class:`~repro_torch.errors.ConfigError`
(``transformer.TransformerLM``).

Parameters are float32, initialised from an explicit
:class:`torch.Generator` (truncated normal at ±2σ, scaled by
1/√fan_in, the reference's ``dense_init``); the reference's weights load
through :func:`repro_torch.models.transformer.load_reference_params`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# config dataclasses (copied: shapes only)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    router: str = "softmax"          # "softmax" | "sigmoid_ds3"
    capacity_factor: float = 1.25
    routed_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attn: str = "gqa"                # "gqa" | "mla"
    qk_norm: bool = False
    window: int | None = None        # sliding-window size (all local layers)
    local_global: tuple[int, int] = (0, 1)   # (n_local, n_global) pattern
    rope_theta: float = 10_000.0
    moe: MoEConfig | None = None
    n_dense_layers: int = 0          # leading dense-FFN layers (DeepSeek: 3)
    dense_d_ff: int | None = None    # d_ff of those dense layers
    mtp: bool = False                # DeepSeek multi-token prediction head
    tie_embeddings: bool = True
    # MLA dims (DeepSeek-V3 defaults)
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    norm_eps: float = 1e-6
    # mixed-precision attention: bf16 QK^T/PV operands with float32
    # accumulation and a float32 softmax
    mp_attn: bool = False

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def layer_window(self, layer: int) -> int | None:
        """Effective attention window of a layer (None = global)."""
        n_loc, n_glob = self.local_global
        if self.window is None:
            return None
        if n_loc == 0:
            return self.window  # uniform SWA
        period = n_loc + n_glob
        return self.window if (layer % period) < n_loc else None


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, in_axis_size: int,
               device=None) -> torch.Tensor:
    """float32 truncated normal at ±2σ, scaled by 1/√``in_axis_size``,
    drawn from ``generator`` on ``device`` (the generator's device when
    None)."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    t = torch.empty(shape, dtype=torch.float32,
                    device=generator.device if device is None else device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _zeros(n: int, device) -> nn.Parameter:
    return _param(torch.zeros(n, dtype=torch.float32, device=device))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the ``(1 + w)`` scale, computed in float32, returned in
    ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    ang = positions[..., None].float() * freqs               # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core (GQA-aware, window + causal + explicit kv positions)
# ---------------------------------------------------------------------------
Q_CHUNK = 1024  # query-chunk size for long-sequence attention


def _attend_dense(q, k, v, q_pos, k_pos, window, k_valid, mixed=False):
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    if mixed:
        # the operands rounded to q's dtype, their products exact and
        # summed in float32 (the reference's preferred_element_type)
        qf = (q * (1.0 / math.sqrt(D))).reshape(B, Sq, Hkv, g, D)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf.float(),
                              k.to(q.dtype).float())
    else:
        qf = (q.float() / math.sqrt(D)).reshape(B, Sq, Hkv, g, D)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None and window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    if k_valid is not None:
        mask = mask & k_valid[:, None, :]
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    if mixed:
        out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(q.dtype).float(),
                           v.to(q.dtype).float())
    else:
        out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, Hq, -1).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, window,
           k_valid: torch.Tensor | None = None, q_chunk: int = Q_CHUNK,
           mixed: bool = False) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D[v]), integer positions.

    Causal mask from positions; ``window`` is an int (``<= 0`` or None
    means global); optional kv-slot validity (rotating caches).  GQA:
    Hq % Hkv == 0.  Long queries run in chunks of ``q_chunk`` (exact
    blockwise attention: each chunk does its full softmax over K), so the
    score tensor never exceeds B·H·q_chunk·Sk."""
    B, Sq, Hq, D = q.shape
    if Sq <= q_chunk or Sq % q_chunk != 0:
        return _attend_dense(q, k, v, q_pos, k_pos, window, k_valid, mixed)
    return torch.cat([
        _attend_dense(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                      k_pos, window, k_valid, mixed)
        for i in range(0, Sq, q_chunk)], dim=1)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------
class GQA(nn.Module):
    """Grouped-query attention's parameters; the constructor is the
    reference's ``init_gqa`` (the same pytree): ``wq`` (d, H, Dh),
    ``wk``/``wv`` (d, Hkv, Dh), ``wo`` (H, Dh, d), and ``q_norm``/
    ``k_norm`` (Dh,) with ``qk_norm``."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = _param(dense_init(generator, (d, H, Dh), d, device))
        self.wk = _param(dense_init(generator, (d, Hkv, Dh), d, device))
        self.wv = _param(dense_init(generator, (d, Hkv, Dh), d, device))
        self.wo = _param(dense_init(generator, (H, Dh, d), H * Dh, device))
        if cfg.qk_norm:
            self.q_norm = _zeros(Dh, device)
            self.k_norm = _zeros(Dh, device)


def apply_gqa(p: GQA, cfg: LMConfig, x, q_pos, *, window, kv_cache=None,
              capture_kv: bool = False):
    """x (B, S, d).  With ``kv_cache`` (decode), a callback that takes the
    new (k, v) and returns the effective (k, v, k_pos, k_valid,
    new_cache); with ``capture_kv`` (prefill), self-attention whose raw
    (k, v) is returned as the cache payload."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    if kv_cache is not None:
        ck, cv, k_pos, k_valid, new_cache = kv_cache(k, v)
        out = attend(q, ck, cv, q_pos, k_pos, window, k_valid,
                     mixed=cfg.mp_attn)
    else:
        new_cache = (k, v) if capture_kv else None
        out = attend(q, k, v, q_pos, q_pos, window, mixed=cfg.mp_attn)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype))
    return y, new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """SwiGLU's parameters (its constructor is the reference's
    ``init_mlp``): ``w_gate``/``w_up`` (d, f), ``w_down`` (f, d)."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator,
                 device):
        super().__init__()
        self.w_gate = _param(dense_init(generator, (d_model, d_ff), d_model,
                                        device))
        self.w_up = _param(dense_init(generator, (d_model, d_ff), d_model,
                                      device))
        self.w_down = _param(dense_init(generator, (d_ff, d_model), d_ff,
                                        device))


def apply_mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p.w_gate.to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p.w_up.to(x.dtype))
    h = nn.functional.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p.w_down.to(x.dtype))
