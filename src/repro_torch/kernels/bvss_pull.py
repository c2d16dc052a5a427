"""BVSS pull: CUDA kernel ``csrc/bvss_pull.cu`` and its entry point.

Port of ``repro/kernels/bvss_pull.py::bvss_pull``.  The TPU kernel's two
layouts (lane-major and row-major tiles) exist for the TPU's (8, 128) vector
registers; on Hopper one warp per VSS with lane ``l`` owning mask word ``l``
is the natural layout, so one kernel serves both.  The public layout is the
reference's: ``(B, 32)`` mask words in, ``(B, 32/σ, 32)`` bool hits out.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bvss_pull_ref

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]


def bvss_pull(masks: torch.Tensor, fbytes: torch.Tensor, *, sigma: int = 8
              ) -> torch.Tensor:
    """masks (B, 32) int32 (uint32 bit patterns), fbytes (B,) int32 frontier
    bytes (pre-gathered via virtualToReal) -> hits (B, 32/σ, 32) bool,
    hits[b, j, l] for slice k = j*32 + l.  CUDA tensors launch the kernel;
    CPU tensors run :func:`~repro_torch.kernels.ref.bvss_pull_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, fbytes):
        return bvss_pull_ref(masks, fbytes, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(fbytes, "fbytes", torch.int32, (B,))
    hits = torch.empty((B, 32 // sigma, 32), dtype=torch.bool,
                       device=masks.device)
    if B:
        fn = _build.bind("bvss_pull", "bvss_pull_launch", _ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), fbytes.data_ptr(), hits.data_ptr(), B,
                 sigma, stream)
        _build.check("bvss_pull", err, "bvss_pull")
        _build.count(bvss_pull)
    return hits


bvss_pull.launches = 0
