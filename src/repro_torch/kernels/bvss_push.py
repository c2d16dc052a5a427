"""BVSS push: CUDA kernels ``csrc/bvss_push.cu`` and their entry points.

* :func:`bvss_push`, the port of ``repro/kernels/bvss_push.py::bvss_push``:
  the pull with a one-hot frontier byte ``1 << bits[b]`` built inside the
  kernel, so a caller ships a ``(B,)`` bit-index vector (DESIGN §2.8);
* :func:`bvss_push_level`, the whole single-source push level in one
  launch: it walks the packed frontier itself and stores into levels or
  marks, where the reference's push level compacts the frontier into a
  vertex queue, expands it into (vertex, VSS) pairs, runs ``bvss_push`` and
  scatters the hits (``repro/core/bfs.py::_make_hybrid_step``).  The
  engines' default push.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.errors import ConfigError
from repro_torch.kernels import _build
from repro_torch.kernels.ref import bvss_push_level_ref, bvss_push_ref

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _LL, _INT, _P]
_LEVEL_ARGTYPES = [_P, _LL, _P, _P, _LL, _P, _P, _INT, _INT, _P, _P, _P]
_I32 = (-(1 << 31), (1 << 31) - 1)


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
        _build.count(bvss_push)
    return hits


bvss_push.launches = 0


def bvss_push_level(F: torch.Tensor, vss_start: torch.Tensor,
                    vss_end: torch.Tensor, masks: torch.Tensor,
                    row_ids: torch.Tensor, lvl: int, *, sigma: int = 8,
                    levels: torch.Tensor | None = None,
                    marks: torch.Tensor | None = None) -> torch.Tensor:
    """One push level, in place: for every set bit v < n of the packed
    frontier and every VSS r in ``[vss_start[v], vss_end[v])``, each slot
    of r that meets the one-hot byte ``1 << (v % σ)`` hits its row; eager
    (``levels``) stores ``lvl`` where the row's level is above ``lvl``,
    lazy (``marks``) stores 1.  Exactly one of the two is given.

    F (n_fwords,) int32 (bits at vertices >= n count as the dummy vertex
    n); vss_start / vss_end (n + 1,) int32; masks (V, 32) int32; row_ids
    (V, 32/σ, 32) int32; levels (N + 1,) int32 or marks (N + 1,) uint8 over
    the rows that ``row_ids`` name, returned after the update.  N is the
    levels' own length, not n: single-device N = n, while a mesh shard's
    rows are its local ``rows_per_shard`` (dummy row N) under the global
    vertex ranges.  The VSS ranges and rows are not checked against the
    arrays: they come from one BVSS (``BVSSDevice`` or a
    ``ShardedBVSSDevice`` block, whose dummy vertex n has an empty range).
    CUDA tensors launch the kernel; CPU tensors run
    :func:`~repro_torch.kernels.ref.bvss_push_level_ref`."""
    from repro_torch.kernels.ops import check_operand, check_sigma, use_kernel
    if (levels is None) == (marks is None):
        raise ConfigError("bvss_push_level takes exactly one of levels= "
                          "(eager) and marks= (lazy)")
    out = marks if levels is None else levels
    if not use_kernel(F, vss_start, vss_end, masks, row_ids, out):
        return bvss_push_level_ref(F, vss_start, vss_end, masks, row_ids,
                                   lvl, sigma, levels=levels, marks=marks)
    check_sigma(sigma)
    if not (isinstance(lvl, int) and _I32[0] <= lvl <= _I32[1]):
        raise ConfigError(f"lvl must be an int32 value, got {lvl!r}")
    n_fwords = F.shape[0] if F.dim() == 1 else -1
    n = vss_start.shape[0] - 1 if vss_start.dim() == 1 else -1
    V = masks.shape[0]
    check_operand(F, "F", torch.int32, (n_fwords,))
    check_operand(vss_start, "vss_start", torch.int32, (n + 1,))
    check_operand(vss_end, "vss_end", torch.int32, (n + 1,))
    check_operand(masks, "masks", torch.int32, (V, 32))
    check_operand(row_ids, "row_ids", torch.int32, (V, 32 // sigma, 32))
    n_rows = out.shape[0] if out.dim() == 1 and out.shape[0] else -1
    if levels is not None:
        check_operand(levels, "levels", torch.int32, (n_rows,))
    else:
        check_operand(marks, "marks", torch.uint8, (n_rows,))
    if masks.data_ptr() % 16:
        raise ConfigError("masks must be 16-byte aligned: the kernel reads "
                          "each 128-byte row as eight 16-byte loads")
    if n_fwords:
        fn = _build.bind("bvss_push", "bvss_push_level_launch",
                         _LEVEL_ARGTYPES)
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = fn(F.data_ptr(), n_fwords, vss_start.data_ptr(),
                 vss_end.data_ptr(), n, masks.data_ptr(), row_ids.data_ptr(),
                 lvl, sigma, None if levels is None else levels.data_ptr(),
                 None if marks is None else marks.data_ptr(), stream)
        _build.check("bvss_push", err, "bvss_push_level")
        _build.count(bvss_push_level)
    return out


bvss_push_level.launches = 0
