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
``*_axes`` functions are the reference's sharding rules.  On DTensors
(a step of the model mesh) the attention core and the MoE run
shard-locally (:func:`_attend_sharded`, :func:`_apply_moe_sharded`, the
latter laid out by the reference's ``moe_spec``); on plain tensors they
are the code above, unchanged.

Parameters are float32, require gradients, and are initialised from an
explicit :class:`torch.Generator` (truncated normal at ±2σ, scaled by
1/√fan_in, the reference's ``dense_init``); the reference's weights load
through :func:`repro_torch.models.transformer.load_reference_params`.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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

def set_unroll(v: bool):
    """The reference's analysis switch, accepted and changing nothing: its
    dry run unrolls every internal loop (layer scans, query-chunk and
    cross-entropy maps) because XLA's cost analysis counts a loop body
    once, and the port's loops are Python loops, which the dry run's
    counters see in full."""


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
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return _attend_sharded(q, k, v, q_pos, k_pos, window, k_valid,
                               q_chunk, mixed)
    B, Sq, Hq, D = q.shape
    if Sq <= q_chunk or Sq % q_chunk != 0:
        return _attend_dense(q, k, v, q_pos, k_pos, window, k_valid, mixed)
    return torch.cat([
        _attend_dense(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                      k_pos, window, k_valid, mixed)
        for i in range(0, Sq, q_chunk)], dim=1)


def _stride(shape) -> tuple[int, ...]:
    """A contiguous tensor's strides (a DTensor's global strides)."""
    return torch.empty(shape, device="meta").stride()


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    shard-local computation hands DTensor back gradients of any stride,
    and DTensor's backward of the op before it may view them."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(t: torch.Tensor, placements, mesh=None,
             grad_placements=None) -> torch.Tensor:
    """This rank's block of ``t`` laid out as ``placements`` (a plain
    ``t`` counts as replicated over ``mesh``), for a shard-local
    computation; its gradient goes back contiguous."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    local = t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grad_placements)
    return _ContiguousGrad.apply(local) if local.requires_grad else local


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (rows of a 1-D or 2-D table) when either is a
    DTensor, shard-locally: every rank looks its own ids (split as
    ``ids`` are) up in its own block of rows (split as the table's rows
    are, over the mesh dims the ids leave free; a split of the columns
    is gathered, as FSDP does), the ids outside its rows give zeros, and
    one all-reduce over the row split adds the blocks (GSPMD's masked
    gather).  The table's gradient comes back as each rank's rows."""
    mesh = next(t.device_mesh for t in (table, ids)
                if isinstance(t, DTensor))
    n = mesh.ndim
    rep = (Replicate(),) * n
    t_pl = table.placements if isinstance(table, DTensor) else rep
    i_pl = ids.placements if isinstance(ids, DTensor) else rep
    id_dims = [i for i, p in enumerate(i_pl) if p.is_shard()]
    row_dims = [i for i, p in enumerate(t_pl)
                if p == Shard(0) and i not in id_dims]
    tab_pl = tuple(Shard(0) if i in row_dims else Replicate()
                   for i in range(n))
    tab_grad = tuple(Shard(0) if i in row_dims else
                     Partial() if i in id_dims else Replicate()
                     for i in range(n))
    t_l = to_local(table, tab_pl, mesh, grad_placements=tab_grad)
    ids_l = to_local(ids, i_pl, mesh)
    block = 0
    for i in row_dims:
        block = block * mesh.shape[i] + mesh.get_coordinate()[i]
    local = ids_l - block * t_l.shape[0]
    hit = (local >= 0) & (local < t_l.shape[0])
    flat = t_l if t_l.dim() == 2 else t_l[:, None]
    out = nn.functional.embedding(torch.where(hit, local, 0), flat) * \
        hit[..., None].to(flat.dtype)
    out = out if t_l.dim() == 2 else out[..., 0]
    shape = (*ids.shape, *table.shape[1:])
    part = tuple(Partial() if i in row_dims else i_pl[i] for i in range(n))
    return DTensor.from_local(out.contiguous(), mesh, part, run_check=False,
                              shape=shape, stride=_stride(shape)
                              ).redistribute(mesh, tuple(
                                  Replicate() if i in row_dims else i_pl[i]
                                  for i in range(n)))


def _attend_sharded(q, k, v, q_pos, k_pos, window, k_valid, q_chunk,
                    mixed):
    """:func:`attend` on DTensors, as the shard-local computation it is:
    attention is independent across examples and heads, so every rank
    attends its own block of both (the batch split as ``q``'s, the
    heads split as ``q``'s when the KV heads divide the same way, else
    whole) and the output keeps that layout.  Each operand is
    redistributed to it first; a key/value sequence split is gathered.
    Plain operands (the positions the model makes) count as
    replicated."""
    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    qp = q.placements if isinstance(q, DTensor) else ()
    b_dims = [i for i, p in enumerate(qp) if isinstance(p, Shard) and
              p.dim == 0]
    h_dims = [i for i, p in enumerate(qp) if isinstance(p, Shard) and
              p.dim == 2]
    if k.shape[2] % math.prod(mesh.shape[i] for i in h_dims):
        h_dims = []

    def placements(head_dim):
        out = [Replicate()] * mesh.ndim
        for i in b_dims:
            out[i] = Shard(0)
        for i in (h_dims if head_dim is not None else ()):
            out[i] = Shard(head_dim)
        return tuple(out)

    def local(t, head_dim=None):
        return None if t is None else to_local(t, placements(head_dim), mesh)

    out = attend(local(q, 2), local(k, 2), local(v, 2), local(q_pos),
                 local(k_pos), window, local(k_valid), q_chunk, mixed)
    shape = (*q.shape[:3], out.shape[-1])
    return DTensor.from_local(out.contiguous(), mesh, placements(2),
                              run_check=False, shape=shape,
                              stride=_stride(shape))


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


def gqa_axes(cfg: LMConfig) -> dict:
    """GQA's logical axes by parameter (the reference's ``gqa_axes``)."""
    a = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qk_norm:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


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


def mla_axes(cfg: LMConfig) -> dict:
    """MLA's logical axes by parameter (the reference's ``mla_axes``)."""
    return {"wq_a": ("embed", "q_lora"), "q_a_norm": (None,),
            "wq_b": ("q_lora", "heads", "head_dim"),
            "wkv_a": ("embed", "kv_lora"), "kv_a_norm": (None,),
            "wk_b": ("kv_lora", "heads", "head_dim"),
            "wv_b": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


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


def mlp_axes() -> dict:
    return {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
            "w_down": ("ffn", "embed")}


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


def moe_axes(cfg: LMConfig) -> dict:
    """The MoE's logical axes by parameter (the reference's
    ``moe_axes``): experts on "experts", ``shared`` an :func:`mlp_axes`."""
    a = {"router": ("embed", None),
         "w_gate": ("experts", "embed", "ffn"),
         "w_up": ("experts", "embed", "ffn"),
         "w_down": ("experts", "ffn", "embed")}
    if cfg.moe.router == "sigmoid_ds3":
        a["router_bias"] = (None,)
    if cfg.moe.n_shared:
        a["shared"] = mlp_axes()
    return a


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


def _moe_dispatch(p, cfg: LMConfig, xt: torch.Tensor):
    """Route xt (G, Tg, d) and fill the expert buffers: (xe (G, E, C, d)
    the slots' tokens, zero where unused; token_of_slot (G, E·C) each
    slot's token in its group; w_slot (G, E·C) each slot's combine
    weight)."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    G, Tg, d = xt.shape
    r = moe_route(p, cfg, xt)
    C = r.capacity
    dev = xt.device
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
    w_k = torch.where(r.keep, r.top_w, 0.0).to(xt.dtype).reshape(G, Tg * K)
    w_slot = torch.zeros((G, size), dtype=xt.dtype, device=dev).scatter(
        1, slot, w_k)[:, :E * C]
    g_idx = torch.arange(G, device=dev)[:, None]
    xe = xt[g_idx, token_of_slot] * used[..., None].to(xt.dtype)
    return xe.reshape(G, E, C, d), token_of_slot, w_slot


def _moe_experts(w_gate, w_up, w_down, xe: torch.Tensor) -> torch.Tensor:
    """The experts over their buffers: xe (G, E, C, d) -> (G, E, C, d),
    one batched matmul an expert over its G·C slots."""
    G, E, C, d = xe.shape
    xe = xe.transpose(0, 1).reshape(E, G * C, d)
    h = nn.functional.silu(xe @ w_gate.to(xe.dtype)) * (xe @ w_up.to(xe.dtype))
    return (h @ w_down.to(xe.dtype)).reshape(E, G, C, d).transpose(0, 1)


def _moe_combine(ye: torch.Tensor, token_of_slot: torch.Tensor,
                 w_slot: torch.Tensor, Tg: int) -> torch.Tensor:
    """Scatter-add each slot's output, times its weight, onto its token:
    ye (G, E, C, d) -> (G, Tg, d)."""
    G, E, C, d = ye.shape
    contrib = ye.reshape(G, E * C, d) * w_slot[..., None]
    g_idx = torch.arange(G, device=ye.device)[:, None]
    rows = (token_of_slot + g_idx * Tg).reshape(-1)
    return torch.zeros((G * Tg, d), dtype=ye.dtype, device=ye.device
                       ).index_add(0, rows, contrib.reshape(-1, d)
                                   ).reshape(G, Tg, d)


def _mesh_dims(mesh, axes) -> list[int]:
    axes = axes if isinstance(axes, (tuple, list)) else (axes,)
    return [list(mesh.mesh_dim_names).index(a) for a in axes]


def _apply_moe_sharded(p: MoE, cfg: LMConfig, x, n_groups: int, moe_spec
                       ) -> torch.Tensor:
    """:func:`apply_moe` on DTensors, as the shard-local program the
    reference's sharding constraints ask of GSPMD: each rank routes and
    fills the buffers of its own groups (the groups split over the
    ``moe_spec`` group axes, else as x's batch is; all groups where
    they do not divide), runs its own experts (split over the expert
    axis, else as ``w_gate``'s experts are), and scatter-adds their
    outputs onto its tokens; the partial sums over the expert axis
    leave as a ``Partial`` DTensor, which one all-reduce completes when
    it is read.  The router's weights are gathered whole."""
    mc = cfg.moe
    B, S, d = x.shape
    E, G = mc.n_experts, n_groups
    Tg = B * S // G
    probe = x if isinstance(x, DTensor) else p.w_gate
    mesh = probe.device_mesh
    n = mesh.ndim
    if moe_spec is not None:
        g_dims, e_dims = _mesh_dims(mesh, moe_spec[0]), \
            _mesh_dims(mesh, moe_spec[1])
    else:
        g_dims = [i for i, q in enumerate(getattr(x, "placements", ()))
                  if isinstance(q, Shard) and q.dim == 0]
        e_dims = [i for i, q in enumerate(getattr(p.w_gate, "placements",
                                                  ())) if q == Shard(0)]
    ng = math.prod(mesh.shape[i] for i in g_dims)
    if G % ng or B % ng:
        g_dims, ng = [], 1
    ne = math.prod(mesh.shape[i] for i in e_dims)
    if E % ne:
        e_dims, ne = [], 1

    def layout(dim_of: dict, partial=()) -> tuple:
        out = [Replicate()] * n
        for dims, tdim in dim_of.items():
            for i in dims:
                out[i] = Shard(tdim)
        for i in partial:
            out[i] = Partial()
        return tuple(out)

    def local(t, dim_of, partial):
        # a replicated input's gradient is a partial sum over the mesh
        # dims that split the work it feeds
        return to_local(t, layout(dim_of), mesh,
                        grad_placements=layout(dim_of, partial))

    x_l = local(x, {tuple(g_dims): 0}, e_dims)
    rep_partial = g_dims + e_dims
    router = SimpleNamespace(
        router=local(p.router, {}, rep_partial),
        router_bias=local(p.router_bias, {}, rep_partial)
        if mc.router == "sigmoid_ds3" else None)
    xe, tos, w_slot = _moe_dispatch(router, cfg, x_l.reshape(G // ng, Tg, d))
    C = xe.shape[2]
    # this rank's experts: its block of the expert axis
    coord = mesh.get_coordinate()
    e_idx = 0
    for i in e_dims:
        e_idx = e_idx * mesh.shape[i] + coord[i]
    el = E // ne
    lo, hi = e_idx * el, (e_idx + 1) * el
    ws = [local(w, {tuple(e_dims): 0}, g_dims)
          for w in (p.w_gate, p.w_up, p.w_down)]
    ye = _moe_experts(*ws, xe[:, lo:hi])
    yt = _moe_combine(ye, tos[:, lo * C:hi * C], w_slot[:, lo * C:hi * C],
                      Tg)
    out_pl = list(layout({tuple(g_dims): 0}))
    for i in e_dims:
        out_pl[i] = Partial()
    y = DTensor.from_local(yt.reshape(x_l.shape), mesh, tuple(out_pl),
                           run_check=False, shape=x.shape,
                           stride=_stride(x.shape))
    if mc.n_shared:
        y = y + apply_mlp(p.shared, x)
    return y


def _constrain(t: torch.Tensor, placements) -> torch.Tensor:
    """``t`` redistributed to ``placements`` when it is a DTensor (the
    reference's ``with_sharding_constraint``); a plain tensor as it is."""
    if placements is None or not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, placements)


def apply_moe(p: MoE, cfg: LMConfig, x: torch.Tensor, *,
              n_groups: int = 1, moe_spec: tuple | None = None
              ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  GShard-style capacity dispatch with
    groups: the B·S tokens are cut into ``n_groups`` groups (which must
    divide B·S), each routing into its own per-expert buffer of
    ``capacity`` slots; a (token, k) pair past its expert's capacity is
    dropped (its weight counts for nothing).  Unused slots enter the
    experts as zeros; the combine scatter-adds each slot's output, times
    its weight, back onto its token (``index_add``).

    On DTensors (a sharded step) it runs shard-locally,
    :func:`_apply_moe_sharded`: ``moe_spec`` (group axes, expert axis)
    names the layout of the (G, E, C, d) expert buffers, the reference's
    sharding constraints on ``xe`` and ``ye``.  On plain tensors
    ``moe_spec`` changes nothing."""
    mc = cfg.moe
    B, S, d = x.shape
    G = n_groups
    if (B * S) % G:
        raise ConfigError(f"moe_groups={G} does not divide the {B * S} "
                          f"tokens of the batch")
    if isinstance(x, DTensor) or isinstance(p.w_gate, DTensor):
        return _apply_moe_sharded(p, cfg, x, G, moe_spec)
    Tg = B * S // G
    xt = x.reshape(G, Tg, d)
    xe, token_of_slot, w_slot = _moe_dispatch(p, cfg, xt)
    ye = _moe_experts(p.w_gate, p.w_up, p.w_down, xe)
    yt = _moe_combine(ye, token_of_slot, w_slot, Tg)
    if mc.n_shared:
        yt = yt + apply_mlp(p.shared, xt)
    return yt.reshape(B, S, d)
