"""BVSS push: CUDA kernel ``csrc/bvss_push.cu`` and its entry point.

Port of ``repro/kernels/bvss_push.py::bvss_push``: the pull with a one-hot
frontier byte ``1 << bits[b]`` built inside the kernel, so the engine ships a
``(B,)`` bit-index vector per push level (DESIGN §2.8).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bvss_push_ref

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]


def bvss_push(masks: torch.Tensor, bits: torch.Tensor, *, sigma: int = 8
              ) -> torch.Tensor:
    """masks (B, 32) int32 mask rows of the queued VSSs, bits (B,) int32 the
    in-set bit ``v % σ`` of the frontier vertex that queued each VSS ->
    hits (B, 32/σ, 32) bool.  CUDA tensors launch the kernel; CPU tensors
    run :func:`~repro_torch.kernels.ref.bvss_push_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, bits):
        return bvss_push_ref(masks, bits, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(bits, "bits", torch.int32, (B,))
    hits = torch.empty((B, 32 // sigma, 32), dtype=torch.bool,
                       device=masks.device)
    if B:
        fn = _build.bind("bvss_push", "bvss_push_launch", _ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), bits.data_ptr(), hits.data_ptr(), B,
                 sigma, stream)
        _build.check("bvss_push", err, "bvss_push")
        bvss_push.launches += 1
    return hits


bvss_push.launches = 0
