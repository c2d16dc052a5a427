"""Gradient compression, the local half of ``repro/train/compression.py``:
int8 quantisation with error feedback (EF-SGD style, Karimireddy et al.
2019).

int8 codes with one float32 scale a tensor cut a data-parallel
all-reduce's bytes 4x against float32, at the cost of quantisation
noise, which error feedback folds back into the next step so training
still converges.  The quantise/dequantise pair wraps a gradient tree (a
flat ``{path: tensor}`` dict) before the reduction; the residuals live
beside the optimizer state.  The reduction itself, the reference's
``compressed_psum``, is a mesh collective: ROADMAP.md queue 1 item 13e.
"""
from __future__ import annotations

import torch


def init_residuals(grads_like: dict) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}


def quantize(g: torch.Tensor, residual: torch.Tensor,
             scale: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + residual -> (int8 codes, scale, new residual).  ``scale`` may be
    given (a scale the replicas share)."""
    x = g.float() + residual
    if scale is None:
        scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - dequantize(q, scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict, residuals: dict):
    """Returns (codes tree, scales tree, new residuals tree)."""
    out = {k: quantize(g, residuals[k]) for k, g in grads.items()}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()},
            {k: o[2] for k, o in out.items()})


def decompress_tree(codes: dict, scales: dict) -> dict:
    return {k: dequantize(q, scales[k]) for k, q in codes.items()}
