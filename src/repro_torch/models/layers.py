"""Transformer building blocks of the LM tier, the port of
``repro/models/layers.py``: RMSNorm, RoPE, GQA and MLA attention
(optional qk-norm, sliding window, causal and slot-validity masks), the
SwiGLU MLP and the capacity-based MoE, as ``nn.Module``s with plain
functions beside them.

The reference's attention, experts and router are plain ``einsum``,
softmax and ``top_k``, not Pallas kernels, and so are the port's: this
module owes no hand kernel.  The MoE's GShard capacity dispatch is the
reference's, slot for slot: the same routes (``top_k`` in JAX's order,
ties to the lower expert), the same capacity, the same drops.  The
reference's ``moe_spec`` sharding constraint belongs to the model mesh
(ROADMAP.md queue 1 item 13e) and is left out.

Parameters are float32, require gradients, and are initialised from an
explicit :class:`torch.Generator` (truncated normal at ±2σ, scaled by
1/√fan_in, the reference's ``dense_init``); the reference's weights load
through :func:`repro_torch.models.transformer.load_reference_params`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.errors import ConfigError

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
    return nn.Parameter(t)


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
# MLA attention (DeepSeek-V3): low-rank Q, compressed KV latent and one
# shared RoPE key a token.  The latent (c_kv, k_rope) is what decode caches.
# ---------------------------------------------------------------------------
class MLA(nn.Module):
    """Multi-head latent attention's parameters; the constructor is the
    reference's ``init_mla`` (the same pytree): ``wq_a`` (d, q_lora),
    ``q_a_norm`` (q_lora,), ``wq_b`` (q_lora, H, qk_nope + qk_rope),
    ``wkv_a`` (d, kv_lora + qk_rope), ``kv_a_norm`` (kv_lora,),
    ``wk_b`` (kv_lora, H, qk_nope), ``wv_b`` (kv_lora, H, v_head) and
    ``wo`` (H, v_head, d)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        qk_d = cfg.qk_nope_dim + cfg.qk_rope_dim
        self.wq_a = _param(dense_init(generator, (d, qr), d, device))
        self.q_a_norm = _zeros(qr, device)
        self.wq_b = _param(dense_init(generator, (qr, H, qk_d), qr, device))
        self.wkv_a = _param(dense_init(
            generator, (d, kvr + cfg.qk_rope_dim), d, device))
        self.kv_a_norm = _zeros(kvr, device)
        self.wk_b = _param(dense_init(generator, (kvr, H, cfg.qk_nope_dim),
                                      kvr, device))
        self.wv_b = _param(dense_init(generator, (kvr, H, cfg.v_head_dim),
                                      kvr, device))
        self.wo = _param(dense_init(generator, (H, cfg.v_head_dim, d),
                                    H * cfg.v_head_dim, device))


def apply_mla(p: MLA, cfg: LMConfig, x, q_pos, *, window=None,
              kv_cache=None, capture_kv: bool = False):
    """x (B, S, d).  The cache payload is the normed latent ``c_kv``
    (B, S, kv_lora) and the rotated shared key ``k_rope`` (B, S, 1,
    qk_rope); both ``kv_cache`` and ``capture_kv`` work as in
    :func:`apply_gqa`.  Every call re-expands the latent to per-head keys
    and values through ``wk_b``/``wv_b`` (matrix absorption is a later
    performance item, not the reference's)."""
    dt = x.dtype
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p.wq_a.to(dt)),
                  p.q_a_norm, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p.wq_b.to(dt))
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                 dim=-1)
    q_full = torch.cat([q_nope, apply_rope(q_rope, q_pos, cfg.rope_theta)],
                       dim=-1)
    kv_a = torch.einsum("bsd,dr->bsr", x, p.wkv_a.to(dt))
    c_kv, k_rope = torch.split(kv_a, [cfg.kv_lora_rank, cfg.qk_rope_dim],
                               dim=-1)
    c_kv = rms_norm(c_kv, p.kv_a_norm, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], q_pos, cfg.rope_theta)
    if kv_cache is not None:
        c_kv, k_rope, k_pos, k_valid, new_cache = kv_cache(c_kv, k_rope)
    else:
        k_pos, k_valid = q_pos, None
        new_cache = (c_kv, k_rope) if capture_kv else None
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p.wk_b.to(dt))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p.wv_b.to(dt))
    k_full = torch.cat([k_nope, k_rope.to(dt).expand(
        *k_nope.shape[:3], cfg.qk_rope_dim)], dim=-1)
    out = attend(q_full, k_full, v, q_pos, k_pos, window, k_valid,
                 mixed=cfg.mp_attn)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(dt))
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


# ---------------------------------------------------------------------------
# capacity-based MoE (GShard-style dispatch)
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """The experts' parameters; the constructor is the reference's
    ``init_moe``: ``router`` (d, E), ``w_gate``/``w_up`` (E, d, F),
    ``w_down`` (E, F, d), ``router_bias`` (E,) with the ``sigmoid_ds3``
    router (it steers the choice only, so it gets no gradient), and
    ``shared``, an :class:`MLP` of width ``F · n_shared``, with shared
    experts."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator, device):
        super().__init__()
        mc = cfg.moe
        d, E, F = cfg.d_model, mc.n_experts, mc.d_expert
        self.router = _param(dense_init(generator, (d, E), d, device))
        self.w_gate = _param(dense_init(generator, (E, d, F), d, device))
        self.w_up = _param(dense_init(generator, (E, d, F), d, device))
        self.w_down = _param(dense_init(generator, (E, F, d), F, device))
        if mc.router == "sigmoid_ds3":
            self.router_bias = _zeros(E, device)
        if mc.n_shared:
            self.shared = MLP(d, F * mc.n_shared, generator, device)


class Routing(NamedTuple):
    """Where each (token, k) pair of a group goes: ``top_w`` (G, Tg, K)
    its combine weight, ``top_idx`` (G, Tg, K) its expert (in
    ``jax.lax.top_k``'s order), ``pos`` (G, Tg, K) its slot in that
    expert's buffer (from the cumulative count over the flattened
    (token, k) order), ``keep`` (G, Tg, K) whether ``pos < capacity``;
    ``capacity`` is the buffer's slots an expert and group."""
    top_w: torch.Tensor
    top_idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    largest first and the lower index first on a tie, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no tie
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: LMConfig, tokens_per_group: int) -> int:
    """Slots an expert and group: ``max(1, ceil(Tg · K / E · factor))``."""
    mc = cfg.moe
    return max(1, int(math.ceil(tokens_per_group * mc.top_k / mc.n_experts
                                * mc.capacity_factor)))


def moe_route(p: MoE, cfg: LMConfig, xt: torch.Tensor) -> Routing:
    """Route xt (G, Tg, d): the softmax router takes the top-k
    probabilities, renormalised; ``sigmoid_ds3`` chooses by sigmoid score
    plus ``router_bias`` and weighs by the raw scores, renormalised and
    scaled by ``routed_scale``."""
    mc = cfg.moe
    G, Tg, _ = xt.shape
    E, K = mc.n_experts, mc.top_k
    logits = torch.einsum("gtd,de->gte", xt, p.router.to(xt.dtype)).float()
    if mc.router == "sigmoid_ds3":
        scores = torch.sigmoid(logits)
        _, top_idx = top_k(scores + p.router_bias[None, None, :], K)
        top_raw = torch.take_along_dim(scores, top_idx, dim=2)
        top_w = top_raw / (top_raw.sum(dim=2, keepdim=True) + 1e-9)
        top_w = top_w * mc.routed_scale
    else:
        top_w, top_idx = top_k(torch.softmax(logits, dim=-1), K)
        top_w = top_w / (top_w.sum(dim=2, keepdim=True) + 1e-9)
    C = moe_capacity(cfg, Tg)
    onehot = nn.functional.one_hot(top_idx, E)                # (G, Tg, K, E)
    pos_in_e = (torch.cumsum(onehot.reshape(G, Tg * K, E), dim=1) - 1
                ).reshape(G, Tg, K, E)
    pos = (pos_in_e * onehot).sum(-1)                         # (G, Tg, K)
    return Routing(top_w, top_idx, pos, pos < C, C)


def apply_moe(p: MoE, cfg: LMConfig, x: torch.Tensor, *,
              n_groups: int = 1) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  GShard-style capacity dispatch with
    groups: the B·S tokens are cut into ``n_groups`` groups (which must
    divide B·S), each routing into its own per-expert buffer of
    ``capacity`` slots; a (token, k) pair past its expert's capacity is
    dropped (its weight counts for nothing).  Unused slots enter the
    experts as zeros; the combine scatter-adds each slot's output, times
    its weight, back onto its token (``index_add``)."""
    mc = cfg.moe
    B, S, d = x.shape
    E, K, G = mc.n_experts, mc.top_k, n_groups
    if (B * S) % G:
        raise ConfigError(f"moe_groups={G} does not divide the {B * S} "
                          f"tokens of the batch")
    Tg = B * S // G
    xt = x.reshape(G, Tg, d)
    r = moe_route(p, cfg, xt)
    C = r.capacity
    dev = x.device
    # slot of each (token, k): its expert's buffer, or a spare slot of its
    # own past the E·C live ones when dropped (so no two pairs share one)
    spare = E * C + torch.arange(Tg * K, device=dev)
    slot = torch.where(r.keep.reshape(G, Tg * K),
                       (r.top_idx * C + r.pos).reshape(G, Tg * K), spare)
    size = E * C + Tg * K
    tok = torch.arange(Tg, device=dev).repeat_interleave(K).expand(G, -1)
    token_of_slot = torch.zeros((G, size), dtype=torch.int64, device=dev
                                ).scatter(1, slot, tok)[:, :E * C]
    used = torch.zeros((G, size), dtype=torch.bool, device=dev).scatter(
        1, slot, r.keep.reshape(G, Tg * K))[:, :E * C]
    w_k = torch.where(r.keep, r.top_w, 0.0).to(x.dtype).reshape(G, Tg * K)
    w_slot = torch.zeros((G, size), dtype=x.dtype, device=dev).scatter(
        1, slot, w_k)[:, :E * C]
    g_idx = torch.arange(G, device=dev)[:, None]
    xe = xt[g_idx, token_of_slot] * used[..., None].to(x.dtype)  # (G, EC, d)
    # the experts: one batched matmul an expert over its G·C slots
    xe = xe.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = nn.functional.silu(xe @ p.w_gate.to(x.dtype)) * \
        (xe @ p.w_up.to(x.dtype))
    ye = (h @ p.w_down.to(x.dtype)).reshape(E, G, C, d).transpose(0, 1)
    contrib = ye.reshape(G, E * C, d) * w_slot[..., None]
    rows = (token_of_slot + g_idx * Tg).reshape(-1)
    yt = torch.zeros((G * Tg, d), dtype=x.dtype, device=dev).index_add(
        0, rows, contrib.reshape(-1, d)).reshape(G, Tg, d)
    if mc.n_shared:
        yt = yt + apply_mlp(p.shared, xt)
    return yt.reshape(B, S, d)
