"""Gradient compression, the local half of ``repro/train/compression.py``:
int8 quantisation with error feedback (EF-SGD style, Karimireddy et al.
2019).

int8 codes with one float32 scale a tensor cut a data-parallel
all-reduce's bytes 4x against float32, at the cost of quantisation
noise, which error feedback folds back into the next step so training
still converges.  The quantise/dequantise pair wraps a gradient tree (a
flat ``{path: tensor}`` dict) before the reduction; the residuals live
beside the optimizer state.  :func:`compressed_psum` is the reduction
over mesh axes: a MAX all-reduce agrees on each leaf's shared scale, a
SUM all-reduce adds the int32 codes (NCCL and gloo both have them, so no
bitwise op is needed).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import (_nbytes, axis_size,
                                                 record_comm)


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


def compressed_psum(grads: dict, residuals: dict, mesh, axes
                    ) -> tuple[dict, dict]:
    """Quantise, add the codes over ``axes`` of ``mesh``, dequantise:
    (the mean over the ranks of ``axes``, this rank's new residuals).
    Every rank of the axes calls it (SPMD).

    The ranks first agree on one scale a leaf (the MAX all-reduce of
    ``max|g + r|``, over 127, plus 1e-12), then quantise with it: the
    int32 sum of int8 codes is exact, and so is dequantising it with the
    shared scale; the only error is each rank's rounding, which its
    residual carries to the next step.  Several axes reduce one after
    another, which for a maximum and an integer sum is the same as one
    reduction over them all."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = math.prod(axis_size(mesh, a) for a in axes)
    groups = [mesh.get_group(a) for a in axes if axis_size(mesh, a) > 1]
    mean, new_res = {}, {}
    for k, g in grads.items():
        peak = torch.max(torch.abs(g.float() + residuals[k])).reshape(1)
        for group in groups:
            dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
        scale = peak[0] / 127.0 + 1e-12
        q, _, new_res[k] = quantize(g, residuals[k], scale=scale)
        q32 = q.to(torch.int32)
        for group in groups:
            record_comm("compressed_psum_codes", _nbytes(q32))
            dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
        mean[k] = q32.float() * scale / n
    return mean, new_res
