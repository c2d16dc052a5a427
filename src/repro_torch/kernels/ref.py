"""Oracles for the port's kernel layer (the ``ref.py`` contract).

Two kinds live here, as in the reference's ``repro/kernels/ref.py``:

* plain PyTorch twins of the port's CUDA kernels.  Each computes exactly
  what its kernel computes, on any device, with plain tensor ops: the CPU
  path of every kernel entry point, the oracle the CPU tests hold against
  the JAX reference, and the yardstick ``chip_smoke.py`` compares each
  kernel with on the card;
* host *analytics* oracles (SciPy / NumPy) for ``repro_torch.analytics``:
  connected components, eccentricity, closeness, Brandes betweenness,
  Dijkstra distances and PageRank computed by an independent
  implementation, in float64, with no per-edge Python loop, so that
  ``chip_smoke.py`` can check graphs of millions of edges on a host
  without NetworkX.

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


def push_level_hits(F: torch.Tensor, vss_start: torch.Tensor,
                    vss_end: torch.Tensor, masks: torch.Tensor,
                    row_ids: torch.Tensor, sigma: int = 8
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What one push level touches: the set bits v < n of the packed
    frontier F (``verts``), the VSS ids of their ranges ``[vss_start[v],
    vss_end[v])`` (``ids``, one per (vertex, VSS) pair), and the rows of
    the pairs' hits under :func:`bvss_push_ref` (``rows`` int64, one per
    hit slot)."""
    dev = F.device
    n = vss_start.shape[0] - 1
    bits = (_u32(F)[:, None] >> torch.arange(32, device=dev)) & 1
    verts = torch.nonzero(bits.reshape(-1)[:n]).reshape(-1)
    first = vss_start[verts].to(torch.int64)
    count = vss_end[verts].to(torch.int64) - first
    pair_vertex = torch.repeat_interleave(
        torch.arange(verts.numel(), device=dev), count)
    pair_offset = torch.arange(pair_vertex.numel(), device=dev) - \
        (torch.cumsum(count, 0) - count)[pair_vertex]
    ids = first[pair_vertex] + pair_offset
    hits = bvss_push_ref(masks[ids],
                         (verts[pair_vertex] % sigma).to(torch.int32), sigma)
    rows = row_ids[ids].reshape(-1).to(torch.int64)[hits.reshape(-1)]
    return verts, ids, rows


def bvss_push_level_ref(F: torch.Tensor, vss_start: torch.Tensor,
                        vss_end: torch.Tensor, masks: torch.Tensor,
                        row_ids: torch.Tensor, lvl: int, sigma: int = 8, *,
                        levels: torch.Tensor | None = None,
                        marks: torch.Tensor | None = None) -> torch.Tensor:
    """Twin of kernels.bvss_push_level, in place: the hit rows of
    :func:`push_level_hits` take ``lvl`` where their level is above it
    (``levels``, eager) or a mark of 1 (``marks``, lazy).  Returns the
    updated tensor."""
    rows = push_level_hits(F, vss_start, vss_end, masks, row_ids, sigma)[2]
    if marks is not None:
        return marks.index_fill_(0, rows, 1)
    return levels.index_fill_(0, rows[levels[rows] > lvl], lvl)


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


def bvss_spmm_mark_ref(masks: torch.Tensor, fbytes: torch.Tensor,
                       row_ids: torch.Tensor, marks: torch.Tensor,
                       sigma: int = 8) -> torch.Tensor:
    """Twin of kernels.bvss_spmm_mark: stores 1 into ``marks`` (L+1, S)
    uint8 at ``(row_ids[b, j, l], s)`` for every hit ``bvss_spmm_ref(masks,
    fbytes, sigma)[b, j, l, s] > 0``, in place, and nothing on a miss;
    returns ``marks``."""
    b, j, l, s = (bvss_spmm_ref(masks, fbytes, sigma) > 0).nonzero(
        as_tuple=True)
    marks[row_ids[b, j, l].to(torch.int64), s] = 1
    return marks


def _slice_bits(masks: torch.Tensor, sigma: int) -> torch.Tensor:
    """(B, 32) int32 mask words -> (B, 32/σ, 32) int64 slices: entry
    ``[b, j, l]`` holds bits σj .. σj+σ-1 of word l, shifted down."""
    shifts = torch.arange(32 // sigma, device=masks.device) * sigma
    return (_u32(masks)[:, None, :] >> shifts[None, :, None]) & \
        ((1 << sigma) - 1)


def bvss_spmm_w_ref(masks: torch.Tensor, xvals: torch.Tensor,
                    sigma: int = 8) -> torch.Tensor:
    """Twin of kernels.bvss_spmm_w: masks (B, 32) int32, xvals (B, σ, S)
    float32 column values -> (B, 32/σ, 32, S) float32; ``[b, j, l, s]``
    sums ``xvals[b, i, s]`` over the set bits i of slice k = j*32 + l.
    The sum runs over i in ascending order, one column at a time (no
    matmul), so the kernel, which adds in the same order, equals it."""
    slices = _slice_bits(masks, sigma)
    acc = torch.zeros(slices.shape + (xvals.shape[2],), dtype=torch.float32,
                      device=masks.device)
    for i in range(sigma):
        bit = ((slices >> i) & 1).bool()[..., None]    # (B, spw, 32, 1)
        acc += torch.where(bit, xvals[:, i, None, None, :], 0.0)
    return acc


def bvss_spmm_t_ref(masks: torch.Tensor, hvals: torch.Tensor,
                    sigma: int = 8) -> torch.Tensor:
    """Twin of kernels.bvss_spmm_t: masks (B, 32) int32, hvals
    (B, 32/σ, 32, S) float32 row values -> (B, σ, S) float32; ``[b, i, s]``
    sums ``hvals[b, j, l, s]`` over the slices k = j*32 + l whose bit i is
    set, in ascending k, one row at a time (no matmul)."""
    slices = _slice_bits(masks, sigma)                         # (B, spw, 32)
    B, spw = slices.shape[0], slices.shape[1]
    ib = torch.arange(sigma, device=masks.device)
    acc = torch.zeros((B, sigma, hvals.shape[3]), dtype=torch.float32,
                      device=masks.device)
    for j in range(spw):
        for l in range(32):
            bit = ((slices[:, j, l, None] >> ib) & 1).bool()   # (B, σ)
            acc += torch.where(bit[:, :, None], hvals[:, j, l, None, :], 0.0)
    return acc


def bvss_spmm_minplus_ref(masks: torch.Tensor, wvals: torch.Tensor,
                          xvals: torch.Tensor, sigma: int = 8
                          ) -> torch.Tensor:
    """Twin of kernels.bvss_spmm_minplus: masks (B, 32) int32, wvals
    (B, 32/σ, 32, σ) float32 edge weights, xvals (B, σ, S) float32 column
    distances -> (B, 32/σ, 32, S) float32; ``[b, j, l, s]`` is the min over
    the set bits i of slice k = j*32 + l of ``wvals[b, j, l, i] +
    xvals[b, i, s]``, +inf where the slice has no bit.  Every operation is
    exactly rounded, so the order of the mins does not matter."""
    slices = _slice_bits(masks, sigma)
    acc = torch.full(slices.shape + (xvals.shape[2],), float("inf"),
                     dtype=torch.float32, device=masks.device)
    for i in range(sigma):
        bit = ((slices >> i) & 1).bool()
        wi = torch.where(bit, wvals[..., i], float("inf"))     # (B, spw, 32)
        acc = torch.minimum(acc, wi[..., None] + xvals[:, i, None, None, :])
    return acc


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


def finalize_sweep_ref(marks: torch.Tensor, levels: torch.Tensor, lvl: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Twin of kernels.finalize_sweep: marks (N,) uint8, levels (N,) int32
    -> ``(levels' (N,) int32, new (N,) bool)``, new where marked and still
    INF, levels' = lvl there."""
    new = (marks > 0) & (levels == INF32)
    return torch.where(new, torch.full_like(levels, lvl), levels), new


def bit_spmm_ref(a_packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Twin of kernels.bit_spmm: a_packed (R, W) int32 packed bit rows (bit
    i of word w is column 32w + i), x (C, S) int8, W·32 >= C -> (R, S)
    int32 ``Y = bits(A)[:, :C] @ X``; bits at columns >= C count nothing.

    The product runs in float64, which holds every partial sum of int8
    values exactly (|Y| <= 128·C, far below 2^53), so any summation order
    gives the integer result (CUDA has no integer matmul).  Unpacks A
    densely: (R, W·32) values, for small R or row chunks only."""
    R, W = a_packed.shape
    C = x.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=a_packed.device)
    bits = (a_packed[:, :, None] >> shifts) & 1   # & 1 drops sign extension
    dense = bits.reshape(R, W * 32)[:, :C].to(torch.float64)
    return (dense @ x.to(torch.float64)).to(torch.int32)


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


def betweenness_ref(g, sources) -> np.ndarray:
    """Brandes partial betweenness Σ_{s∈sources} δ_s(v), unnormalised,
    endpoints excluded, in float64 — the quantity
    ``repro_torch.analytics.betweenness`` accumulates.

    Level-synchronous and vectorised over the sources: the forward phase
    takes one SciPy sparse product per BFS level for all sources at once
    (σ of the next level = Aᵀ · σ of the frontier, at the vertices not yet
    reached), the backward phase one per level in reverse (δ(v) += σ(v) ·
    Σ_{v→w, d(w)=d(v)+1} (1 + δ(w)) / σ(w)).  No per-edge Python loop, so
    it serves graphs of millions of edges."""
    A = _csr_matrix(g).astype(np.float64)              # A[u, v]: edge u→v
    At = A.T.tocsr()
    sources = np.asarray(sources, dtype=np.int64)
    n, S = g.n, len(sources)
    bc = np.zeros(n, dtype=np.float64)
    if S == 0 or n == 0:
        return bc
    cols = np.arange(S)
    dist = np.full((n, S), -1, dtype=np.int64)
    sigma = np.zeros((n, S), dtype=np.float64)
    dist[sources, cols] = 0
    sigma[sources, cols] = 1.0
    front = dist == 0
    d = 0
    while front.any():
        contrib = At @ np.where(front, sigma, 0.0)         # (n, S)
        new = (dist < 0) & (contrib > 0)
        d += 1
        dist[new] = d
        sigma[new] = contrib[new]
        front = new
    delta = np.zeros((n, S), dtype=np.float64)
    safe = np.where(sigma > 0, sigma, 1.0)
    for t in range(d, 0, -1):
        coeff = A @ np.where(dist == t, (1.0 + delta) / safe, 0.0)
        delta += np.where(dist == t - 1, sigma * coeff, 0.0)
    delta[sources, cols] = 0.0
    return delta.sum(axis=1)


def _csr_matrix_w(g, weights: np.ndarray):
    import scipy.sparse as sp
    return sp.csr_matrix(
        (np.asarray(weights, dtype=np.float64), g.indices, g.indptr),
        shape=(g.n, g.n))


def sssp_ref(g, sources, weights: np.ndarray) -> np.ndarray:
    """Single-source shortest-path oracle via SciPy Dijkstra on the
    weighted CSR (directed, ``weights`` in ``g``'s edge order): (S, n)
    float64 distances, +inf for unreachable vertices."""
    from scipy.sparse.csgraph import dijkstra
    sources = np.asarray(sources, dtype=np.int64)
    return dijkstra(_csr_matrix_w(g, weights), directed=True,
                    indices=sources)


def pagerank_ref(g, *, damping: float = 0.85, tol: float = 1e-12,
                 max_iter: int = 1000) -> np.ndarray:
    """PageRank oracle: float64 power iteration over the DiGraph of ``g``
    with a uniform out-edge split, run until the L1 change of an iteration
    falls below ``tol``.  Sink vertices redistribute their mass uniformly
    (the rule of ``repro_torch.analytics.pagerank`` and of NetworkX's
    ``pagerank`` without a ``dangling`` vector)."""
    n = g.n
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    A = _csr_matrix(g).astype(np.float64)
    outdeg = np.diff(g.indptr).astype(np.float64)
    sink = outdeg == 0
    inv = np.where(sink, 0.0, 1.0 / np.where(sink, 1.0, outdeg))
    r = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        r2 = (1.0 - damping) / n + damping * (A.T @ (r * inv)
                                              + r[sink].sum() / n)
        done = np.abs(r2 - r).sum() < tol
        r = r2
        if done:
            break
    return r
