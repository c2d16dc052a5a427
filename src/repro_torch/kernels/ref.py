"""Oracles for the port's kernel layer (the ``ref.py`` contract).

Two kinds live here, as in the reference's ``repro/kernels/ref.py``:

* plain PyTorch twins of the port's CUDA kernels.  Each computes exactly
  what its kernel computes, on any device, with plain tensor ops: the CPU
  path of every kernel entry point, the oracle the CPU tests hold against
  the JAX reference, and the yardstick ``chip_smoke.py`` compares each
  kernel with on the card;
* host *analytics* oracles (SciPy / NumPy) for ``repro_torch.analytics``:
  connected components, eccentricity and closeness computed by an
  independent implementation.

Words are ``torch.int32`` tensors carrying uint32 bit patterns.  PyTorch
has no shifts on ``torch.uint32``, so the twins widen to int64, mask to
32 bits, work there, and narrow back with ``.to(torch.int32)``, which
wraps: bit 31 survives every round trip.
"""
from __future__ import annotations

import numpy as np
import torch

INF32 = (1 << 31) - 1
_U32 = 0xFFFFFFFF


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned 32-bit value."""
    return words.to(torch.int64) & _U32


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool (n_words*32, *cols) -> int32 (n_words, *cols): bit i of word w
    is ``bits[32w + i]``, column by column."""
    cols = bits.shape[1:]
    b = bits.reshape(-1, 32, *cols).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    return (b * weights.view(32, *[1] * len(cols))).sum(dim=1).to(
        torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int64 values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


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


def bvss_spmm_ref(masks: torch.Tensor, fbytes: torch.Tensor, sigma: int = 8
                  ) -> torch.Tensor:
    """Twin of kernels.bvss_spmm: masks (B, 32) int32, fbytes (B, S) int32 ->
    (B, 32/σ, 32, S) int32 popcounts of slice ∧ frontier byte per stacked
    source column; only bits 0..σ-1 of each frontier byte count."""
    spw = 32 // sigma
    smask = (1 << sigma) - 1
    shifts = torch.arange(spw, device=masks.device) * sigma
    slices = (_u32(masks)[:, None, :] >> shifts[None, :, None]) & smask
    fb = _u32(fbytes) & smask                              # (B, S)
    return popcount(slices[..., None] & fb[:, None, None, :]).to(torch.int32)


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


# ---------------------------------------------------------------------------
# analytics oracles (SciPy / NumPy) — the repro_torch.analytics contract
# ---------------------------------------------------------------------------
def _csr_matrix(g):
    import scipy.sparse as sp
    return sp.csr_matrix(
        (np.ones(g.m, dtype=np.int8), g.indices, g.indptr), shape=(g.n, g.n))


def connected_components_ref(g) -> np.ndarray:
    """Weakly-connected component labels via SciPy, normalised so that
    component ids are assigned in order of each component's smallest
    vertex id (the canonical form ``repro_torch.analytics.components``
    emits)."""
    from scipy.sparse.csgraph import connected_components
    _, labels = connected_components(_csr_matrix(g), directed=True,
                                     connection="weak")
    return normalize_labels(labels)


def normalize_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel components to 0..k-1 in order of first appearance (labels
    may be arbitrary ints, e.g. union-find roots)."""
    labels = np.asarray(labels)
    _, first, inverse = np.unique(labels, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first)
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    return remap[inverse]


def eccentricity_ref(g, sources) -> np.ndarray:
    """Per-source eccentricity on ``g`` as given (symmetrise first for the
    classical undirected definition): the max *finite* BFS distance, so a
    vertex isolated from the rest of its graph has eccentricity 0."""
    from scipy.sparse.csgraph import dijkstra
    sources = np.asarray(sources, dtype=np.int64)
    dist = dijkstra(_csr_matrix(g), directed=True, unweighted=True,
                    indices=sources)
    dist = np.where(np.isfinite(dist), dist, 0.0)
    return dist.max(axis=1).astype(np.int64)


def closeness_ref(g, sources=None, *, wf_improved: bool = False
                  ) -> np.ndarray:
    """Closeness centrality oracle via SciPy BFS distances: outward
    distances over ``g`` as given (symmetrise first for the classical
    undirected definition) — c(s) = (reach-1)/Σ d(s, ·), 0 for a source
    reaching nothing.  ``sources=None`` evaluates every vertex (the exact
    variant); ``wf_improved`` applies the Wasserman–Faust
    ``(reach-1)/(n-1)`` scaling."""
    from scipy.sparse.csgraph import dijkstra
    if sources is None:
        sources = np.arange(g.n)
    sources = np.asarray(sources, dtype=np.int64)
    if len(sources) == 0:
        return np.zeros(0, dtype=np.float64)
    dist = dijkstra(_csr_matrix(g), directed=True, unweighted=True,
                    indices=sources)                       # (S, n)
    finite = np.isfinite(dist)
    dist_sum = np.where(finite, dist, 0.0).sum(axis=1)
    reach = finite.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        cc = np.where(dist_sum > 0, (reach - 1) / dist_sum, 0.0)
    if wf_improved and g.n > 1:
        cc = cc * (reach - 1) / (g.n - 1)
    return cc
