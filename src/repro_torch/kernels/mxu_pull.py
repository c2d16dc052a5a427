"""Bit-tile products: CUDA kernels ``csrc/bit_spmm.cu``,
``csrc/bvss_spmm.cu``, ``csrc/bvss_spmm_w.cu``, ``csrc/bvss_spmm_t.cu`` and
``csrc/bvss_spmm_minplus.cu`` and their entry points.

``bit_spmm`` ports ``repro/kernels/mxu_pull.py::bit_spmm``, the dense
popcount SpMM ``Y = bits(A) @ X`` of the dense multi-source baseline
(``repro_torch.bench.bench_service``): the TPU kernel unpacks 128-column
stripes of A for its matrix unit; here a warp streams a row's words and
adds the X rows of its set bits.

Port of ``repro/kernels/mxu_pull.py::bvss_spmm``, the multi-source pull of
the wave engine (DESIGN §2.5): per queued VSS, the ``(τ, σ)`` slice bits
against the ``(σ, S)`` frontier bits of S stacked sources, as popcounts.
The TPU kernel unpacks both to int8 tiles for its matrix unit; on Hopper
each count is one AND and one ``__popc`` on the packed words, and the
``(B, 32/σ, 32, S)`` int32 output is the cost: a warp per VSS writes its
contiguous output in 512-byte runs of whole sectors (the source note has
the design and why tensor cores do not help).  ``bvss_spmm_mark`` is the
same kernel with a second epilogue, the wave engine's main path: no count
is written, and each hit stores 1 into the uint8 mark of its row and
column, where the engine used to scatter the counts' hits itself.  The
reference's ``tile_b``/``tile_s`` knobs exist for the TPU's VMEM and are
not ported.

The three float tiles of the analytics semiring (DESIGN §2.6, §2.9) port
``bvss_spmm_w`` (σ path counts, PageRank), ``bvss_spmm_t`` (the Brandes
backward sweep) and ``bvss_spmm_minplus`` (the SSSP relaxation).  The
TPU kernels unpack the mask bits into a float tile for its matrix or
vector unit; here each output is one chain of f32 adds (or mins) over
the set bits in ascending order, so each kernel equals its twin bit for
bit.  ``bvss_spmm_w`` writes like ``bvss_spmm`` (a warp per VSS, 512-byte
runs of whole sectors); ``bvss_spmm_t`` stages a VSS's row values in
shared memory with 16-byte asynchronous copies and reduces them there
(the source notes have both designs).  The ``*_local`` forms are
indexing around a kernel, as in the reference, not kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.errors import ConfigError
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (bit_spmm_ref, bvss_spmm_mark_ref,
                                     bvss_spmm_minplus_ref, bvss_spmm_ref,
                                     bvss_spmm_t_ref, bvss_spmm_w_ref)

_P = ctypes.c_void_p
_T_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               _P]
_MP_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, _P]
_MARK_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_int, _P]
_BIT_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
_MAX_BLOCKS = 2 ** 31 - 1      # gridDim.x
_SMEM_BYTES = 48 * 1024        # static shared memory of one block, no opt-in


def bit_spmm(a_packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Popcount-semiring SpMM ``Y = bits(A)[:, :C] @ X``: a_packed (R, W)
    int32 (uint32 bit rows; bit i of word w is column 32w + i), x (C, S)
    int8 with W·32 >= C -> (R, S) int32, exact for any int8 X; bits at
    columns >= C count nothing.  CUDA tensors launch the kernel; CPU
    tensors run :func:`~repro_torch.kernels.ref.bit_spmm_ref`."""
    from repro_torch.kernels.ops import check_operand, use_kernel
    if not use_kernel(a_packed, x):
        return bit_spmm_ref(a_packed, x)
    R, W = a_packed.shape if a_packed.dim() == 2 else (-1, -1)
    C, S = x.shape if x.dim() == 2 else (-1, -1)
    check_operand(a_packed, "a_packed", torch.int32, (R, W))
    check_operand(x, "x", torch.int8, (C, S))
    if W * 32 < C:
        raise ConfigError(f"bit_spmm: {W} words per row hold fewer than the "
                          f"C = {C} columns of x")
    if 128 * C >= 2 ** 31 or -(-R // 8) > _MAX_BLOCKS:
        raise ConfigError(f"bit_spmm: R = {R}, C = {C} exceed one launch "
                          f"or the int32 sums")
    y = torch.empty((R, S), dtype=torch.int32, device=a_packed.device)
    if R and S:
        # 16-byte word loads need every row 16-byte aligned
        vec = int(W % 4 == 0 and a_packed.data_ptr() % 16 == 0)
        fn = _build.bind("bit_spmm", "bit_spmm_launch", _BIT_ARGTYPES)
        stream = torch.cuda.current_stream(a_packed.device).cuda_stream
        err = fn(a_packed.data_ptr(), x.data_ptr(), y.data_ptr(), R, W, C, S,
                 vec, stream)
        _build.check("bit_spmm", err, "bit_spmm")
        _build.count(bit_spmm)
    return y


bit_spmm.launches = 0


def bvss_spmm(masks: torch.Tensor, fbytes: torch.Tensor, *, sigma: int = 8
              ) -> torch.Tensor:
    """masks (B, 32) int32 (uint32 bit patterns), fbytes (B, S) int32 — the
    σ-bit frontier byte of each VSS's slice set per stacked source (bits at
    and above σ are ignored) -> (B, 32/σ, 32, S) int32 popcounts;
    ``[b, j, l, s]`` is slice ``k = j*32 + l`` against source ``s``.  Any B
    (a warp per VSS) and any S; S in {4, 8, 16, 32, 64, 128} takes the
    16-byte store path, and the kernel picks 16-byte or 4-byte frontier
    loads by the alignment of ``fbytes``.
    CUDA tensors launch the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.bvss_spmm_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, fbytes):
        return bvss_spmm_ref(masks, fbytes, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    S = fbytes.shape[1] if fbytes.dim() == 2 else -1
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(fbytes, "fbytes", torch.int32, (B, S))
    out = torch.empty((B, 32 // sigma, 32, S), dtype=torch.int32,
                      device=masks.device)
    if B and S:
        # (masks, fbytes, out, B, S, sigma, stream): bvss_spmm_t's signature
        fn = _build.bind("bvss_spmm", "bvss_spmm_launch", _T_ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), fbytes.data_ptr(), out.data_ptr(), B, S,
                 sigma, stream)
        _build.check("bvss_spmm", err, "bvss_spmm")
        _build.count(bvss_spmm)
    return out


bvss_spmm.launches = 0


def bvss_spmm_mark(masks: torch.Tensor, fbytes: torch.Tensor,
                   row_ids: torch.Tensor, marks: torch.Tensor, *,
                   sigma: int = 8) -> torch.Tensor:
    """The wave engine's pull with its marks fused in: masks (B, 32) and
    fbytes (B, S) int32 as in :func:`bvss_spmm`, row_ids (B, 32/σ, 32)
    int32 the rows of each slice (``row_ids[ids]``, values in [0, L]),
    marks (L+1, S) uint8, updated in place and returned:
    ``marks[row_ids[b, j, l], s] = 1`` wherever slice ``k = j*32 + l`` of
    VSS b meets column s's frontier byte (``bvss_spmm(...)[b, j, l, s] >
    0``); nothing is stored on a miss, and no count is written.  Any B and
    S, the same two paths as :func:`bvss_spmm`; a VSS with an all-zero
    mask (the queue's dummy padding) costs one 128-byte load.  CUDA
    tensors launch the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.bvss_spmm_mark_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, fbytes, row_ids, marks):
        return bvss_spmm_mark_ref(masks, fbytes, row_ids, marks, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    S = fbytes.shape[1] if fbytes.dim() == 2 else -1
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(fbytes, "fbytes", torch.int32, (B, S))
    check_operand(row_ids, "row_ids", torch.int32, (B, 32 // sigma, 32))
    check_operand(marks, "marks", torch.uint8, (marks.shape[0], S))
    if B and S:
        fn = _build.bind("bvss_spmm", "bvss_spmm_mark_launch",
                         _MARK_ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), fbytes.data_ptr(), row_ids.data_ptr(),
                 marks.data_ptr(), B, S, sigma, stream)
        _build.check("bvss_spmm", err, "bvss_spmm_mark")
        _build.count(bvss_spmm_mark)
    return marks


bvss_spmm_mark.launches = 0


def _check_block_columns(name: str, B: int, S: int, sigma: int) -> None:
    """A one-block-per-VSS kernel (``bvss_spmm_minplus``) stages a (σ, S)
    f32 block in shared memory and launches B blocks."""
    if 4 * sigma * S > _SMEM_BYTES:
        raise ConfigError(
            f"{name}: S = {S} columns at sigma = {sigma} need "
            f"{4 * sigma * S} B of shared memory per block, above "
            f"{_SMEM_BYTES}")


def bvss_spmm_w(masks: torch.Tensor, xvals: torch.Tensor, *,
                sigma: int = 8) -> torch.Tensor:
    """Weighted BVSS pull: masks (B, 32) int32 (uint32 bit patterns), xvals
    (B, σ, S) float32 values of each VSS's σ slice-set columns -> (B, 32/σ,
    32, S) float32; ``[b, j, l, s]`` sums the values of the set bits of
    slice ``k = j*32 + l`` (scatter-add it into rows via ``row_ids``).
    Any B (a warp per VSS) and any S; S = 1 and, with 16-byte aligned
    ``xvals`` rows, S in {4, 8, ..., 128} take 16-byte stores, every other
    case 4-byte ones (the kernel picks by the alignment of ``xvals``, as
    :func:`bvss_spmm_t` does by that of ``hvals``).  CUDA tensors launch
    the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.bvss_spmm_w_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, xvals):
        return bvss_spmm_w_ref(masks, xvals, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    S = xvals.shape[2] if xvals.dim() == 3 else -1
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(xvals, "xvals", torch.float32, (B, sigma, S))
    spw = 32 // sigma
    out = torch.empty((B, spw, 32, S), dtype=torch.float32,
                      device=masks.device)
    if B and S:
        fn = _build.bind("bvss_spmm_w", "bvss_spmm_w_launch", _T_ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), xvals.data_ptr(), out.data_ptr(), B, S,
                 sigma, stream)
        _build.check("bvss_spmm_w", err, "bvss_spmm_w")
        _build.count(bvss_spmm_w)
    return out


bvss_spmm_w.launches = 0


def bvss_spmm_t(masks: torch.Tensor, hvals: torch.Tensor, *,
                sigma: int = 8) -> torch.Tensor:
    """Transposed weighted BVSS product: masks (B, 32) int32, hvals
    (B, 32/σ, 32, S) float32 per-row values -> (B, σ, S) float32;
    ``[b, i, s]`` sums the values of the rows whose slice has bit i set
    (scatter-add it into columns).  Any B and S: a warp per VSS and tile
    of ``min(S, σ)`` columns (rounded down to a power of two); the kernel
    picks 16-byte or 4-byte copies by the alignment of ``hvals``.  CUDA
    tensors launch the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.bvss_spmm_t_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, hvals):
        return bvss_spmm_t_ref(masks, hvals, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    spw = 32 // sigma
    S = hvals.shape[3] if hvals.dim() == 4 else -1
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(hvals, "hvals", torch.float32, (B, spw, 32, S))
    out = torch.empty((B, sigma, S), dtype=torch.float32,
                      device=masks.device)
    if B and S:
        fn = _build.bind("bvss_spmm_t", "bvss_spmm_t_launch", _T_ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), hvals.data_ptr(), out.data_ptr(), B, S,
                 sigma, stream)
        _build.check("bvss_spmm_t", err, "bvss_spmm_t")
        _build.count(bvss_spmm_t)
    return out


bvss_spmm_t.launches = 0


def bvss_spmm_minplus(masks: torch.Tensor, wvals: torch.Tensor,
                      xvals: torch.Tensor, *, sigma: int = 8
                      ) -> torch.Tensor:
    """Tropical (min, +) BVSS pull: masks (B, 32) int32, wvals (B, 32/σ, 32,
    σ) float32 weight-plane rows (``build_weight_plane`` layout), xvals
    (B, σ, S) float32 column distances (+inf unreached) -> (B, 32/σ, 32, S)
    float32; ``[b, j, l, s]`` is the min over the set bits i of slice
    ``k = j*32 + l`` of ``wvals[b, j, l, i] + xvals[b, i, s]``, +inf for a
    slice with no bit (scatter-min it into rows via ``row_ids``).  CUDA
    tensors launch the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.bvss_spmm_minplus_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if not use_kernel(masks, wvals, xvals):
        return bvss_spmm_minplus_ref(masks, wvals, xvals, sigma)
    check_sigma(sigma)
    B = masks.shape[0]
    spw = 32 // sigma
    S = xvals.shape[2] if xvals.dim() == 3 else -1
    check_operand(masks, "masks", torch.int32, (B, 32))
    check_operand(wvals, "wvals", torch.float32, (B, spw, 32, sigma))
    check_operand(xvals, "xvals", torch.float32, (B, sigma, S))
    _check_block_columns("bvss_spmm_minplus", B, S, sigma)
    out = torch.empty((B, spw, 32, S), dtype=torch.float32,
                      device=masks.device)
    if B and S:
        fn = _build.bind("bvss_spmm_minplus", "bvss_spmm_minplus_launch",
                         _MP_ARGTYPES)
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), wvals.data_ptr(), xvals.data_ptr(),
                 out.data_ptr(), B, S, sigma, int(S % 4 == 0), stream)
        _build.check("bvss_spmm_minplus", err, "bvss_spmm_minplus")
        _build.count(bvss_spmm_minplus)
    return out


bvss_spmm_minplus.launches = 0


# ---------------------------------------------------------------------------
# local-rows × global-columns forms: indexing around the kernels
# ---------------------------------------------------------------------------
def _column_ids(sets: torch.Tensor, sigma: int) -> torch.Tensor:
    """(B,) slice-set ids -> (B, σ) column ids; set j owns [σj, σ(j+1))."""
    return (sets.to(torch.int64)[:, None] * sigma
            + torch.arange(sigma, device=sets.device)[None, :])


def bvss_spmm_w_local(masks: torch.Tensor, sets: torch.Tensor,
                      xglobal: torch.Tensor, *, sigma: int = 8,
                      impl=None) -> torch.Tensor:
    """Weighted pull of a queued VSS batch against a column-value array:
    gathers each VSS's (σ, S) slice-set block out of ``xglobal`` (C, S)
    float32, C >= n_sets·σ, and contracts it with the (τ, σ) bit tile.
    ``sets`` (B,) are the slice-set ids (``virtual_to_real[ids]``).
    ``impl`` overrides the tile product (the σ-channel seam)."""
    f = bvss_spmm_w if impl is None else impl
    return f(masks, xglobal[_column_ids(sets, sigma)], sigma=sigma)


def bvss_spmm_minplus_local(masks: torch.Tensor, wvals: torch.Tensor,
                            sets: torch.Tensor, xglobal: torch.Tensor, *,
                            sigma: int = 8, impl=None) -> torch.Tensor:
    """Min-plus pull of a queued VSS batch against a column-distance array
    (C, S) float32: the tropical twin of :func:`bvss_spmm_w_local`, with
    ``wvals`` the queued weight-plane rows (``wplane[Q]``)."""
    f = bvss_spmm_minplus if impl is None else impl
    return f(masks, wvals, xglobal[_column_ids(sets, sigma)], sigma=sigma)


def bvss_spmm_t_local(masks: torch.Tensor, row_ids: torch.Tensor,
                      hrows: torch.Tensor, *, sigma: int = 8,
                      impl=None) -> torch.Tensor:
    """Transposed weighted product against per-row values (R + 1, S)
    float32 gathered through ``row_ids`` (B, 32/σ, 32) (the dummy row R
    indexes ``hrows``'s zero tail) -> (B, σ, S) per-column partial sums."""
    f = bvss_spmm_t if impl is None else impl
    return f(masks, hrows[row_ids.to(torch.int64)], sigma=sigma)
