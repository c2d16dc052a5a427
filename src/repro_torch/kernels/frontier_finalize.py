"""End-of-level sweeps: CUDA kernels ``csrc/frontier_finalize.cu`` and
their entry points.

Port of ``repro/kernels/frontier_finalize.py``:

* ``finalize_pack_sweep``, the fused sweep: one pass over the vertices
  emits the finalised levels (lazy mode), the packed frontier words and the
  per-slice-set active flags (DESIGN §2.3); the kernel streams four
  vertices a lane per 16-byte access, two accesses in flight, and writes
  each warp pass's words and flags as contiguous runs;
* ``finalize_sweep``, the minimal unit (Alg. 3 stage 2): finalised levels
  and the "new" flags from lazy marks, the baseline of the fused sweep
  (``repro_torch.bench.kernel_bench`` times the two side by side).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import finalize_pack_ref, finalize_sweep_ref

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _LL, _LL, _LL, ctypes.c_int, ctypes.c_int,
             _P]
_SWEEP_ARGTYPES = [_P, _P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P]


def finalize_pack_sweep(levels: torch.Tensor, lvl: int, *, sigma: int,
                        n_fwords: int, n_sets: int,
                        marks: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused sweep: finalise + frontier-pack + set-active flags.

    levels: (N,) int32 over real vertices (N = n).
    lvl:    current level (>= 1), a plain int.
    marks:  (N,) uint8 lazy marks, or None for eager mode (newness =
            ``levels == lvl``; the returned levels ARE the input tensor).
    Returns ``(levels' (N,) int32, fwords (n_fwords,) int32,
    set_active (n_sets,) bool)``.  The kernel takes views that are not
    16-byte aligned (``levels[1:]``) one vertex at a time.  CUDA tensors
    launch the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.finalize_pack_ref`.
    """
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    operands = (levels,) if marks is None else (levels, marks)
    if not use_kernel(*operands):
        return finalize_pack_ref(levels, lvl, sigma=sigma, n_fwords=n_fwords,
                                 n_sets=n_sets, marks=marks)
    check_sigma(sigma)
    N = levels.shape[0]
    check_operand(levels, "levels", torch.int32, (N,))
    fwords = torch.empty((n_fwords,), dtype=torch.int32, device=levels.device)
    act = torch.empty((n_sets,), dtype=torch.bool, device=levels.device)
    if marks is None:
        lv_out = levels
        marks_ptr = out_ptr = None
    else:
        check_operand(marks, "marks", torch.uint8, (N,))
        lv_out = torch.empty_like(levels)
        marks_ptr, out_ptr = marks.data_ptr(), lv_out.data_ptr()
    if max(N, n_fwords * 32, n_sets * sigma):
        fn = _build.bind("frontier_finalize", "finalize_pack_launch",
                         _ARGTYPES)
        stream = torch.cuda.current_stream(levels.device).cuda_stream
        err = fn(levels.data_ptr(), marks_ptr, out_ptr, fwords.data_ptr(),
                 act.data_ptr(), N, n_fwords, n_sets, sigma, int(lvl), stream)
        _build.check("frontier_finalize", err, "finalize_pack_sweep")
        _build.count(finalize_pack_sweep)
    return lv_out, fwords, act


finalize_pack_sweep.launches = 0


def finalize_sweep(marks: torch.Tensor, levels: torch.Tensor, lvl: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """marks (N,) uint8, levels (N,) int32, lvl a plain int -> new tensors
    ``(levels' (N,) int32, new (N,) bool)``: new where marked and still
    INF, levels' = lvl there.  CUDA tensors launch the kernel; CPU tensors
    run :func:`~repro_torch.kernels.ref.finalize_sweep_ref`."""
    from repro_torch.kernels.ops import check_operand, use_kernel
    if not use_kernel(marks, levels):
        return finalize_sweep_ref(marks, levels, lvl)
    N = levels.shape[0] if levels.dim() == 1 else -1
    check_operand(marks, "marks", torch.uint8, (N,))
    check_operand(levels, "levels", torch.int32, (N,))
    lv_out = torch.empty_like(levels)
    new = torch.empty((N,), dtype=torch.bool, device=levels.device)
    if N:
        # the 4-wide loads and stores need 16-byte levels, 4-byte marks
        vec = int(levels.data_ptr() % 16 == 0 and lv_out.data_ptr() % 16 == 0
                  and marks.data_ptr() % 4 == 0 and new.data_ptr() % 4 == 0)
        fn = _build.bind("frontier_finalize", "finalize_sweep_launch",
                         _SWEEP_ARGTYPES)
        stream = torch.cuda.current_stream(levels.device).cuda_stream
        err = fn(marks.data_ptr(), levels.data_ptr(), lv_out.data_ptr(),
                 new.data_ptr(), N, int(lvl), vec, stream)
        _build.check("frontier_finalize", err, "finalize_sweep")
        _build.count(finalize_sweep)
    return lv_out, new


finalize_sweep.launches = 0
