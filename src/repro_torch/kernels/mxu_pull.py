"""Batched BVSS bit-SpMM: CUDA kernel ``csrc/bvss_spmm.cu`` and its entry
point.

Port of ``repro/kernels/mxu_pull.py::bvss_spmm``, the multi-source pull of
the wave engine (DESIGN §2.5): per queued VSS, the ``(τ, σ)`` slice bits
against the ``(σ, S)`` frontier bits of S stacked sources, as popcounts.
The TPU kernel unpacks both to int8 tiles for its matrix unit; on Hopper
each count is one AND and one ``__popc`` on the packed words, and the
``(B, 32/σ, 32, S)`` int32 output is the cost.  The reference's
``tile_b``/``tile_s`` knobs exist for the TPU's VMEM and are not ported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.errors import ConfigError
from repro_torch.kernels import _build
from repro_torch.kernels.ref import bvss_spmm_ref

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P]
_MAX_BLOCKS = 2 ** 31 - 1      # gridDim.x; one 256-thread block per 256 rows


def bvss_spmm(masks: torch.Tensor, fbytes: torch.Tensor, *, sigma: int = 8
              ) -> torch.Tensor:
    """masks (B, 32) int32 (uint32 bit patterns), fbytes (B, S) int32 — the
    σ-bit frontier byte of each VSS's slice set per stacked source (bits at
    and above σ are ignored) -> (B, 32/σ, 32, S) int32 popcounts;
    ``[b, j, l, s]`` is slice ``k = j*32 + l`` against source ``s``.  CUDA
    tensors launch the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.bvss_spmm_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, fbytes):
        return bvss_spmm_ref(masks, fbytes, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    S = fbytes.shape[1] if fbytes.dim() == 2 else -1
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(fbytes, "fbytes", torch.int32, (B, S))
    spw = 32 // sigma
    if B * spw * 32 > _MAX_BLOCKS * 256:
        raise ConfigError(f"bvss_spmm: B = {B} VSSs exceed one launch")
    out = torch.empty((B, spw, 32, S), dtype=torch.int32, device=masks.device)
    if B and S:
        # 16-byte row stores need S % 4 == 0 and 16-byte aligned operands
        vec = int(S % 4 == 0 and fbytes.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
        fn = _build.bind("bvss_spmm", "bvss_spmm_launch", _ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), fbytes.data_ptr(), out.data_ptr(), B, S,
                 sigma, vec, stream)
        _build.check("bvss_spmm", err, "bvss_spmm")
        bvss_spmm.launches += 1
    return out


bvss_spmm.launches = 0
