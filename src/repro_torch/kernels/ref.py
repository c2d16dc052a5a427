"""Plain PyTorch twins of the port's CUDA kernels (the ``ref.py`` contract).

Each twin computes exactly what its kernel computes, on any device, with
plain tensor ops: the CPU path of every kernel entry point, the oracle the
CPU tests hold against the JAX reference (``repro/kernels/ref.py``), and
the yardstick ``chip_smoke.py`` compares each kernel with on the card.

Words are ``torch.int32`` tensors carrying uint32 bit patterns.  PyTorch
has no shifts on ``torch.uint32``, so the twins widen to int64, mask to
32 bits, work there, and narrow back with ``.to(torch.int32)``, which
wraps: bit 31 survives every round trip.
"""
from __future__ import annotations

import torch

INF32 = (1 << 31) - 1
_U32 = 0xFFFFFFFF


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned 32-bit value."""
    return words.to(torch.int64) & _U32


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool (n_words*32,) -> int32 (n_words,), bit i of word w = bits[32w+i]."""
    b = bits.reshape(-1, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    return (b * weights).sum(dim=1).to(torch.int32)


def bvss_pull_ref(masks: torch.Tensor, fbytes: torch.Tensor, sigma: int = 8
                  ) -> torch.Tensor:
    """Twin of kernels.bvss_pull: masks (B, 32) int32, fbytes (B,) int32 ->
    hits (B, 32/σ, 32) bool; hits[b, j, l] iff slot j of word l meets the
    σ-bit frontier byte of VSS b."""
    spw = 32 // sigma
    smask = (1 << sigma) - 1
    fb = _u32(fbytes) & smask
    fword = torch.zeros_like(fb)
    for j in range(spw):
        fword = fword | (fb << (sigma * j))
    anded = _u32(masks) & fword[:, None]
    hits = [((anded >> (sigma * j)) & smask) != 0 for j in range(spw)]
    return torch.stack(hits, dim=1)


def bvss_push_ref(masks: torch.Tensor, bits: torch.Tensor, sigma: int = 8
                  ) -> torch.Tensor:
    """Twin of kernels.bvss_push: the pull against the one-hot frontier
    byte ``1 << bits[b]`` (a bit index outside [0, 32) gives no byte, as a
    uint32 shift past the word does in the reference)."""
    b = bits.to(torch.int64)
    inside = (b >= 0) & (b < 32)
    fb = torch.where(inside, torch.ones_like(b) << b.clamp(0, 31),
                     torch.zeros_like(b))
    return bvss_pull_ref(masks, fb.to(torch.int32), sigma)


def finalize_pack_ref(levels: torch.Tensor, lvl: int, *, sigma: int,
                      n_fwords: int, n_sets: int,
                      marks: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Twin of kernels.finalize_pack_sweep: finalise + frontier-pack +
    set-active flags.  Returns ``(levels' (N,) int32, fwords (n_fwords,)
    int32, set_active (n_sets,) bool)``; eager mode (``marks is None``)
    returns the input ``levels`` itself."""
    if marks is None:                       # eager: scatter-min already ran
        new = levels == lvl
        lv_out = levels
    else:                                   # lazy: finalise from byte marks
        new = (marks > 0) & (levels == INF32)
        lv_out = torch.where(new, torch.full_like(levels, lvl), levels)
    N = new.shape[0]
    bits = torch.zeros(n_fwords * 32, dtype=torch.bool, device=new.device)
    bits[:N] = new
    sbits = torch.zeros(n_sets * sigma, dtype=torch.bool, device=new.device)
    sbits[:N] = new
    return lv_out, pack_words(bits), sbits.reshape(n_sets, sigma).any(dim=1)
