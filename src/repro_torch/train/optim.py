"""Optimizers, the port of ``repro/train/optim.py``: AdamW, SGD-momentum,
Adafactor-lite; learning-rate schedules; global-norm clipping.

A parameter "tree" here is a flat ``{path: tensor}`` dict (the
reference's pytree leaves by path, :func:`repro_torch.models.transformer.
reference_leaves`).  The update rules are the reference's, written over
tensors and out of place (each returns new tensors), not
``torch.optim``'s: AdamW decays only leaves of two or more dimensions
(the reference's stacked layer groups count their layer axis) and adds
``eps`` outside the square root after bias correction, and Adafactor
factors the last two axes of a leaf.  AdamW keeps its moments in
``moment_dtype`` (bfloat16 halves their bytes, the DeepSeek-V3 recipe).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

Params = dict


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree.values()))


def clip_by_global_norm(tree: Params, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale for k, g in tree.items()}, norm


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``final_frac · peak_lr`` at ``total``; a float32 scalar."""
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant_lr(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    max_grad_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


def adamw_init(params: Params, cfg: AdamWConfig) -> OptState:
    def zeros(p):   # zeros_like keeps a DTensor leaf's placements
        return torch.zeros_like(p, dtype=cfg.moment_dtype)
    return OptState(step=_step0(), m={k: zeros(p) for k, p in params.items()},
                    v={k: zeros(p) for k, p in params.items()})


def adamw_update(grads: Params, state: OptState, params: Params,
                 cfg: AdamWConfig, lr: torch.Tensor):
    grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        m32 = b1 * state.m[k].float() + (1 - b1) * g32
        v32 = b2 * state.v[k].float() + (1 - b2) * g32 * g32
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:   # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k] = m32.to(cfg.moment_dtype)
        new_v[k] = v32.to(cfg.moment_dtype)
    return new_p, OptState(step=step, m=new_m, v=new_v), gnorm


# ---------------------------------------------------------------------------
# SGD momentum (baseline optimizer)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SGDConfig:
    momentum: float = 0.9
    max_grad_norm: float = 1.0


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: Params


def sgd_init(params: Params, cfg: SGDConfig) -> SGDState:
    return SGDState(step=_step0(), mom={
        k: torch.zeros_like(p, dtype=torch.float32)
        for k, p in params.items()})


def sgd_update(grads: Params, state: SGDState, params: Params,
               cfg: SGDConfig, lr: torch.Tensor):
    grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    new_p, new_m = {}, {}
    for k, p in params.items():
        m32 = cfg.momentum * state.mom[k] + grads[k].float()
        new_p[k] = (p.float() - lr * m32).to(p.dtype)
        new_m[k] = m32
    return new_p, SGDState(step=state.step + 1, mom=new_m), gnorm


# ---------------------------------------------------------------------------
# Adafactor-lite: factored second moment for giant embedding tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    max_grad_norm: float = 1.0


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Params   # row second moments (or full for <2-D leaves)
    vc: Params   # col second moments (zeros for <2-D leaves)


def adafactor_init(params: Params, cfg: AdafactorConfig) -> AdafactorState:
    def rows(p):
        shape = p.shape[:-1] if p.dim() >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdafactorState(step=_step0(),
                          vr={k: rows(p) for k, p in params.items()},
                          vc={k: cols(p) for k, p in params.items()})


def adafactor_update(grads: Params, state: AdafactorState, params: Params,
                     cfg: AdafactorConfig, lr: torch.Tensor):
    grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
    d = cfg.decay
    new_p, new_vr, new_vc = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        g2 = g32 * g32 + cfg.eps
        vr, vc = state.vr[k], state.vc[k]
        if p.dim() >= 2:
            nvr = d * vr + (1 - d) * g2.mean(dim=-1)
            nvc = d * vc + (1 - d) * g2.mean(dim=-2)
            denom = (nvr[..., None] * nvc[..., None, :]
                     / torch.clamp(nvr.mean(dim=-1, keepdim=True)[..., None],
                                   min=cfg.eps))
            update = g32 / torch.sqrt(torch.clamp(denom, min=cfg.eps))
        else:
            nvr = d * vr + (1 - d) * g2
            nvc = vc
            update = g32 / torch.sqrt(torch.clamp(nvr, min=cfg.eps))
        rms = torch.sqrt(torch.mean(update * update) + 1e-12)
        update = update / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        new_p[k] = (p.float() - lr * update).to(p.dtype)
        new_vr[k], new_vc[k] = nvr, nvc
    return new_p, AdafactorState(state.step + 1, new_vr, new_vc), gnorm


OPTIMIZERS = {
    "adamw": (AdamWConfig, adamw_init, adamw_update),
    "sgd": (SGDConfig, sgd_init, sgd_update),
    "adafactor": (AdafactorConfig, adafactor_init, adafactor_update),
}
