"""Binarised Virtual Slice Sets (BVSS) — the paper's core data structure (§3).

The port of ``repro/core/bvss.py``: host construction is the same
vectorised NumPy (byte-equal arrays), and :func:`to_device` hands the
arrays to PyTorch on an explicit device.  The mesh-native build path
(DESIGN §2.4) partitions the same arrays by rows (:func:`build_sharded_bvss`)
or by rows and columns (:func:`build_sharded_bvss_2d`), and
:func:`shard_to_device` hands one rank its own block.  Layout (σ = slice width in bits,
LANES = 32 words per VSS row-group, slices_per_word = 32 // σ,
τ = LANES * slices_per_word):

* column *intervals* of σ consecutive columns of A^T form *slice sets*;
* a (row u, interval i) pair with ≥1 edge is a *slice*, its σ-bit mask holds
  A^T[u, σi : σ(i+1)];
* each slice set is split into *virtual* slice sets of ≤ τ slices (the unit
  of work), the last VSS of a set is padded to τ with zero masks / dummy rows;
* within a VSS, slices sorted by row id are laid out column-major over
  (slot, lane): slice k lives in lane ``k % 32``, sub-word slot ``k // 32``
  — the paper's Fig. 2(c) layout.  On Hopper a VSS row-group is one warp:
  lane ``l`` owns mask word ``l``.

Device mask words are ``torch.int32`` holding the uint32 bit patterns
unchanged (PyTorch has no shifts on ``torch.uint32``); every consumer masks
after a right shift, so the sign extension of ``>>`` never leaks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.distributed.bfs_dist import mesh_rank_device
from repro_torch.errors import ConfigError, GraphValidationError
from repro_torch.graphs import Graph, from_edges, src_of_edges

LANES = 32  # 32-bit words per VSS row-group (paper: WARP_SIZE)


@dataclasses.dataclass(frozen=True)
class BVSS:
    """Host-side BVSS arrays + structural metadata."""

    n: int                      # number of vertices
    m: int                      # number of edges
    sigma: int                  # slice width (bits)
    tau: int                    # slices per VSS = LANES * (32 // sigma)
    n_sets: int                 # ceil(n / sigma) real slice sets
    num_vss: int
    num_slices: int             # unpadded slices
    # static arrays (paper §3.1)
    masks: np.ndarray           # (num_vss, LANES) uint32; slot j of word l
                                #   = mask of slice k = j*LANES + l
    row_ids: np.ndarray         # (num_vss, 32//sigma, LANES) int32; dummy = n
    real_ptrs: np.ndarray       # (n_sets + 1,) int32: slice set -> VSS range
    virtual_to_real: np.ndarray  # (num_vss,) int32

    @staticmethod
    def from_arrays(masks: np.ndarray, row_ids: np.ndarray,
                    real_ptrs: np.ndarray, virtual_to_real: np.ndarray, *,
                    n: int, m: int, sigma: int) -> "BVSS":
        """Wrap host arrays built elsewhere (e.g. by the JAX reference's
        ``build_bvss``) as this port's :class:`BVSS`, so both packages can
        run on the very same state.  Shapes and dtypes are validated; the
        derived counts (``tau``, ``n_sets``, ``num_vss``, ``num_slices``)
        are recomputed from the arrays."""
        if not (1 <= sigma <= 32 and 32 % sigma == 0):
            raise GraphValidationError(
                f"sigma must be a divisor of 32 in [1, 32], got {sigma!r}")
        spw = 32 // sigma
        n_sets = (n + sigma - 1) // sigma
        masks = np.asarray(masks)
        num_vss = masks.shape[0] if masks.ndim == 2 else -1
        want = {"masks": ((num_vss, LANES), np.uint32, masks),
                "row_ids": ((num_vss, spw, LANES), np.int32, row_ids),
                "real_ptrs": ((n_sets + 1,), np.int32, real_ptrs),
                "virtual_to_real": ((num_vss,), np.int32, virtual_to_real)}
        arrs = {}
        for name, (shape, dtype, a) in want.items():
            a = np.asarray(a)
            if a.shape != shape or a.dtype != dtype:
                raise GraphValidationError(
                    f"{name} has shape {a.shape} and dtype {a.dtype}, "
                    f"expected {shape} {np.dtype(dtype)}")
            arrs[name] = a
        if int(arrs["real_ptrs"][-1]) != num_vss:
            raise GraphValidationError(
                f"real_ptrs ends at {int(arrs['real_ptrs'][-1])}, but there "
                f"are {num_vss} VSSs")
        shifts = (np.arange(spw, dtype=np.uint32) * sigma)[None, :, None]
        smask = np.uint32((1 << sigma) - 1)
        num_slices = int(np.count_nonzero(
            (arrs["masks"][:, None, :] >> shifts) & smask))
        return BVSS(n=n, m=m, sigma=sigma, tau=LANES * spw, n_sets=n_sets,
                    num_vss=num_vss, num_slices=num_slices, **arrs)

    @property
    def slices_per_word(self) -> int:
        return 32 // self.sigma

    @property
    def n_frontier_words(self) -> int:
        """Frontier bit-array length in uint32 words (σ-bit set granularity)."""
        return (self.n_sets * self.sigma + 31) // 32

    @property
    def max_vss_per_set(self) -> int:
        """Largest VSS count of any slice set — the static expansion factor
        of the push phase (each pushing vertex enqueues every VSS of its own
        set, DESIGN §2.8)."""
        if self.n_sets == 0:
            return 1
        return max(int(np.diff(self.real_ptrs).max()), 1)

    # ---------------- analytics (paper Tables 1 & 4) ----------------
    def compression_ratio(self) -> float:
        """m / (num_slices * σ): fraction of set bits in unpadded masks."""
        if self.num_slices == 0:
            return 1.0
        return self.m / (self.num_slices * self.sigma)

    def connectivity_bits(self) -> int:
        """Bits of the unpadded slices, num_slices * σ (Table 4's
        connectivity column)."""
        return self.num_slices * self.sigma

    def memory_bytes(self) -> dict[str, int]:
        """Table-4 style footprint breakdown (bytes), as the reference
        counts it: ``bvss`` the static arrays, ``dynamic`` the queues and
        frontier words (``push`` the auto-mode push working set, a sub-term
        of it), ``level`` the level array; ``total`` = bvss + dynamic +
        level."""
        static = (self.masks.nbytes + self.row_ids.nbytes
                  + self.real_ptrs.nbytes + self.virtual_to_real.nbytes)
        pq = max(128, self.n // 8)  # default auto-mode push cap
        push = 4 * (pq + 1) + 2 * 4 * pq * self.max_vss_per_set
        dynamic = (2 * 4 * (self.num_vss + 1)
                   + 2 * 4 * self.n_frontier_words + push)
        level = 4 * (self.n + 1)
        return {"bvss": static, "dynamic": dynamic, "push": push,
                "level": level, "total": static + dynamic + level}

    def update_divergence(self) -> float:
        """Paper §3.2.1: mean over VSSs of the mean per-slot std of live row ids."""
        spw = self.slices_per_word
        sig = self.sigma
        sub_mask = np.uint32((1 << sig) - 1)
        # sub[v, j, l] = mask of slice (slot j, lane l)
        shifts = (np.arange(spw, dtype=np.uint32) * sig)[None, :, None]
        sub = (self.masks[:, None, :] >> shifts) & sub_mask
        live = sub != 0
        rows = self.row_ids.astype(np.float64)
        cnt = live.sum(axis=2)                                   # (v, j)
        s1 = np.where(live, rows, 0.0).sum(axis=2)
        s2 = np.where(live, rows * rows, 0.0).sum(axis=2)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = s1 / cnt
            var = np.maximum(s2 / cnt - mean * mean, 0.0)
            col_div = np.sqrt(var)                               # (v, j)
        nonempty = cnt > 0
        set_cnt = nonempty.sum(axis=1)
        set_div = np.where(set_cnt > 0,
                           np.where(nonempty, col_div, 0.0).sum(axis=1)
                           / np.maximum(set_cnt, 1), 0.0)
        alive = set_cnt > 0
        return float(set_div[alive].mean()) if alive.any() else 0.0

    # ---------------- validation helpers ----------------
    def reconstruct_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Recover (src, dst) edge lists: bit b of slice (u, i) ⇒ edge (σi+b) → u."""
        spw, sig = self.slices_per_word, self.sigma
        shifts = (np.arange(spw, dtype=np.uint32) * sig)[None, :, None]
        sub = (self.masks[:, None, :] >> shifts) & np.uint32((1 << sig) - 1)
        vss_idx, slot, lane = np.nonzero(sub)
        sub_v = sub[vss_idx, slot, lane]
        rows = self.row_ids[vss_idx, slot, lane].astype(np.int64)
        sets = self.virtual_to_real[vss_idx].astype(np.int64)
        src_l, dst_l = [], []
        for b in range(sig):
            has = (sub_v >> np.uint32(b)) & 1 != 0
            src_l.append(sets[has] * sig + b)
            dst_l.append(rows[has])
        return np.concatenate(src_l), np.concatenate(dst_l)


def build_bvss(g: Graph, sigma: int = 8) -> BVSS:
    if not (1 <= sigma <= 32 and 32 % sigma == 0):
        raise GraphValidationError(
            f"sigma must be a divisor of 32 in [1, 32], got {sigma!r}")
    spw = 32 // sigma
    tau = LANES * spw
    n, m = g.n, g.m
    n_sets = (n + sigma - 1) // sigma

    t_indptr, t_indices = g.t_csr
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(t_indptr))
    cols = t_indices.astype(np.int64)
    interval = cols // sigma
    bit = (cols % sigma).astype(np.uint32)

    # unique (interval, row) pairs, interval-major / row-ascending
    keys = interval * n + rows
    ukeys, inverse = np.unique(keys, return_inverse=True)
    num_slices = len(ukeys)
    slice_mask = np.zeros(num_slices, dtype=np.uint32)
    np.bitwise_or.at(slice_mask, inverse, np.uint32(1) << bit)
    slice_interval = (ukeys // n).astype(np.int64)
    slice_row = (ukeys % n).astype(np.int32)

    # slices per set -> VSS counts -> realPtrs
    set_counts = np.bincount(slice_interval, minlength=n_sets)
    vss_counts = (set_counts + tau - 1) // tau
    real_ptrs = np.zeros(n_sets + 1, dtype=np.int32)
    real_ptrs[1:] = np.cumsum(vss_counts)
    num_vss = int(real_ptrs[-1])
    virtual_to_real = np.repeat(np.arange(n_sets, dtype=np.int32), vss_counts)

    # placement of each slice
    set_starts = np.zeros(n_sets + 1, dtype=np.int64)
    np.cumsum(set_counts, out=set_starts[1:])
    local = np.arange(num_slices, dtype=np.int64) - set_starts[slice_interval]
    vss = real_ptrs[slice_interval].astype(np.int64) + local // tau
    k = local % tau
    lane = (k % LANES).astype(np.int64)
    slot = (k // LANES).astype(np.int64)

    masks = np.zeros((num_vss, LANES), dtype=np.uint32)
    np.bitwise_or.at(masks.reshape(-1), vss * LANES + lane,
                     slice_mask << (slot * sigma).astype(np.uint32))
    row_ids = np.full((num_vss, spw, LANES), n, dtype=np.int32)  # dummy = n
    row_ids[vss, slot, lane] = slice_row

    return BVSS(n=n, m=m, sigma=sigma, tau=tau, n_sets=n_sets,
                num_vss=num_vss, num_slices=num_slices, masks=masks,
                row_ids=row_ids, real_ptrs=real_ptrs,
                virtual_to_real=virtual_to_real)


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  ``None`` means ``"cuda"``; a CUDA device without a card
    is a :class:`ConfigError` — the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(
                f"device {str(dev)!r} requested but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ConfigError(
            f"device must be a CUDA device or 'cpu', got {str(dev)!r}")
    return dev


class BVSSDevice(NamedTuple):
    """Device-resident BVSS. One extra all-zero dummy VSS is appended so
    padded queue entries are harmless, and the level array gets an extra
    slot for dummy row id ``n``."""

    masks: torch.Tensor            # (num_vss + 1, LANES) int32 (uint32 bits)
    row_ids: torch.Tensor          # (num_vss + 1, spw, LANES) int32
    virtual_to_real: torch.Tensor  # (num_vss + 1,) int32
    real_ptrs: torch.Tensor        # (n_sets + 1,) int32
    vss_of_vertex_start: torch.Tensor  # (n + 1,) int32 = real_ptrs[v // σ]
    vss_of_vertex_end: torch.Tensor


def to_device(b: BVSS, device: "str | torch.device | None" = None
              ) -> BVSSDevice:
    dev = resolve_device(device)
    masks = np.concatenate([b.masks, np.zeros((1, LANES), np.uint32)], axis=0)
    row_ids = np.concatenate(
        [b.row_ids, np.full((1, b.slices_per_word, LANES), b.n, np.int32)],
        axis=0)
    v2r = np.concatenate([b.virtual_to_real, np.zeros(1, np.int32)])
    verts = np.arange(b.n, dtype=np.int64)
    sets = verts // b.sigma
    start = b.real_ptrs[sets].astype(np.int32)
    end = b.real_ptrs[sets + 1].astype(np.int32)
    # dummy vertex n: empty VSS range so a spurious mark enqueues nothing
    start = np.concatenate([start, np.zeros(1, np.int32)])
    end = np.concatenate([end, np.zeros(1, np.int32)])

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return BVSSDevice(
        masks=put(masks.view(np.int32)),
        row_ids=put(row_ids),
        virtual_to_real=put(v2r),
        real_ptrs=put(b.real_ptrs),
        vss_of_vertex_start=put(start),
        vss_of_vertex_end=put(end),
    )


# ---------------------------------------------------------------------------
# Weight plane: per-edge float weights aligned with the bit slices
# (the min-plus / weighted-verb operand, DESIGN §2.9)
# ---------------------------------------------------------------------------
def build_weight_plane(g: Graph, weights: np.ndarray,
                       sigma: int = 8) -> np.ndarray:
    """Lay per-edge weights out exactly like the BVSS mask bits.

    ``weights`` is one float per CSR edge of ``g`` (``g.indices`` order).
    Returns a (num_vss, 32//σ, LANES, σ) float32 plane where entry
    ``[v, slot, lane, i]`` is the weight of the edge encoded by bit σ·slot+i
    of ``masks[v, lane]`` — i.e. the same (slot, lane) slice placement
    :func:`build_bvss` computes — and +inf wherever that bit is unset (the
    tropical-semiring annihilator, so masked and missing edges agree).
    Parallel edges (if any survive ingress) keep the minimum weight.
    """
    if not (1 <= sigma <= 32 and 32 % sigma == 0):
        raise GraphValidationError(
            f"sigma must be a divisor of 32 in [1, 32], got {sigma!r}")
    spw = 32 // sigma
    tau = LANES * spw
    n = g.n
    n_sets = (n + sigma - 1) // sigma

    t_indptr, t_indices = g.t_csr
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(t_indptr))
    cols = t_indices.astype(np.int64)
    # t_csr edge j is original CSR edge argsort(indices)[j] (stable sort by
    # destination) — permute the weights into the same transposed order
    w_t = np.asarray(weights, dtype=np.float32)[
        np.argsort(g.indices, kind="stable")]
    interval = cols // sigma
    bit = (cols % sigma).astype(np.int64)

    # identical slice placement to build_bvss
    keys = interval * n + rows
    ukeys, inverse = np.unique(keys, return_inverse=True)
    num_slices = len(ukeys)
    slice_interval = (ukeys // n).astype(np.int64)
    set_counts = np.bincount(slice_interval, minlength=n_sets)
    vss_counts = (set_counts + tau - 1) // tau
    real_ptrs = np.zeros(n_sets + 1, dtype=np.int64)
    real_ptrs[1:] = np.cumsum(vss_counts)
    num_vss = int(real_ptrs[-1])
    set_starts = np.zeros(n_sets + 1, dtype=np.int64)
    np.cumsum(set_counts, out=set_starts[1:])
    local = np.arange(num_slices, dtype=np.int64) - set_starts[slice_interval]
    vss = real_ptrs[slice_interval] + local // tau
    k = local % tau
    lane = k % LANES
    slot = k // LANES

    plane = np.full((num_vss, spw, LANES, sigma), np.inf, dtype=np.float32)
    np.minimum.at(plane, (vss[inverse], slot[inverse], lane[inverse], bit),
                  w_t)
    return plane


def build_sharded_weight_plane(g: Graph, weights: np.ndarray,
                               sb: "ShardedBVSS") -> np.ndarray:
    """Row-sharded twin of :func:`build_weight_plane`: one weight plane per
    shard of ``sb``, built over the same destination-range subgraphs
    :func:`build_sharded_bvss` committed (so slice placement matches the
    sharded masks bit for bit), padded to the common VSS count with +inf.
    Returns (D, num_vss_pad, 32//σ, LANES, σ) float32."""
    n = g.n
    sigma = sb.sigma
    spw = sb.slices_per_word
    src = src_of_edges(g).astype(np.int64)
    dst = g.indices.astype(np.int64)
    w = np.asarray(weights, dtype=np.float32)
    D, rps = sb.n_shards, sb.rows_per_shard
    plane = np.full((D, sb.num_vss_pad, spw, LANES, sigma), np.inf,
                    dtype=np.float32)
    for d in range(D):
        lo, hi = d * rps, min((d + 1) * rps, n)
        keep = (dst >= lo) & (dst < hi)
        if not keep.any():
            continue
        # from_edges(dedup=True) emits edges in ascending (src·n + dst)
        # key order — reduce the kept weights into that order (min merges
        # parallel edges exactly like the mask OR does)
        key = src[keep] * n + (dst[keep] - lo)
        uk, inv = np.unique(key, return_inverse=True)
        wsub = np.full(len(uk), np.inf, dtype=np.float32)
        np.minimum.at(wsub, inv, w[keep])
        sub = from_edges(n, src[keep], dst[keep] - lo,
                         dedup=True, drop_loops=False)
        pd = build_weight_plane(sub, wsub, sigma=sigma)
        plane[d, :pd.shape[0]] = pd
    return plane


def weight_plane_to_device(plane: np.ndarray,
                           device: "str | torch.device | None" = None, *,
                           mesh=None, axis: str = "data") -> torch.Tensor:
    """Commit a weight plane to ``device`` (default: the card) as a
    ``(num_vss + 1, 32/σ, LANES, σ)`` float32 tensor.  The appended last
    row is all +inf: it mirrors the all-zero dummy mask row of
    :func:`to_device`, so padded queue entries relax nothing.

    A sharded plane ``(D, num_vss_pad, 32/σ, LANES, σ)``
    (:func:`build_sharded_weight_plane`) takes the ``mesh``: this rank
    keeps only its own shard (``axis``'s local rank), with the +inf row
    appended, on its own device, the weight twin of
    :func:`shard_to_device`."""
    if plane.ndim == 5:
        if mesh is None:
            raise ConfigError("a sharded weight plane needs the mesh that "
                              "says which shard this rank keeps")
        dev = mesh_rank_device(mesh, device)
        plane = plane[mesh.get_local_rank(axis)]
    else:
        dev = resolve_device(device)
    full = np.concatenate(
        [plane, np.full((1,) + plane.shape[1:], np.inf, np.float32)], axis=0)
    return torch.from_numpy(np.ascontiguousarray(full)).to(dev)


# ---------------------------------------------------------------------------
# Row-sharded BVSS (mesh-native build path, DESIGN §2.4)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedBVSS:
    """Row-partitioned BVSS: shard d owns destination rows
    [d·rows_per_shard, (d+1)·rows_per_shard), i.e. the slices that pull INTO
    its vertex range.  Row ids are LOCAL (dummy = rows_per_shard); slice-set
    ids stay GLOBAL, because columns (frontier bits) are global — the σ-bit
    frontier words are the one all-gathered array.  All shards are padded to
    a common VSS count so one program serves every shard."""

    n: int                       # global vertex count
    m: int                       # global edge count
    sigma: int
    n_shards: int
    rows_per_shard: int          # 32-aligned so row blocks = frontier words
    num_vss_pad: int             # per-shard VSS count (padded to common max)
    n_sets: int                  # GLOBAL slice sets (columns)
    masks: np.ndarray            # (D, num_vss_pad, LANES) uint32
    row_ids: np.ndarray          # (D, num_vss_pad, spw, LANES) int32 LOCAL
    virtual_to_real: np.ndarray  # (D, num_vss_pad) int32 GLOBAL set ids
    vss_start: np.ndarray        # (D, n + 1) int32 GLOBAL vertex -> LOCAL
    vss_end: np.ndarray          #   VSS range [start, end) of the shard's
                                 #   slice sets for the vertex's own set;
                                 #   dummy vertex n maps to the empty range
    max_vss_per_set: int         # static push expansion factor (max shard)

    @property
    def slices_per_word(self) -> int:
        return 32 // self.sigma

    @property
    def n_frontier_words(self) -> int:
        """Gathered (global) frontier length in uint32 words: the all-gather
        of every shard's rows_per_shard//32 local words.  Covers n_sets·σ
        bits because rows_per_shard·D ≥ n rounded up to 32."""
        return self.n_shards * (self.rows_per_shard // 32)


def build_sharded_bvss(g: Graph, n_shards: "int | tuple[int, int]",
                       sigma: int = 8) -> "ShardedBVSS | ShardedBVSS2D":
    """Row-partition ``g`` into ``n_shards`` rectangular (local rows ×
    global columns) BVSS blocks.

    Each shard's block is built by :func:`build_bvss` over the subgraph of
    edges whose DESTINATION lands in the shard's row range, destinations
    relabelled locally and sources (columns / frontier ids) kept global.

    A ``(rows, cols)`` tuple selects the 2-D row × column partition
    instead (:func:`build_sharded_bvss_2d`): device (i, j) owns the slices
    pulling its row block from its column block of frontier words."""
    if isinstance(n_shards, tuple):
        rows, cols = n_shards
        return build_sharded_bvss_2d(g, rows, cols, sigma=sigma)
    n = g.n
    rows_per_shard = -(-n // n_shards)
    rows_per_shard = ((rows_per_shard + 31) // 32) * 32  # align frontier words
    spw = 32 // sigma
    src = src_of_edges(g)
    dst = g.indices.astype(np.int64)
    per_shard = []
    for d in range(n_shards):
        lo, hi = d * rows_per_shard, min((d + 1) * rows_per_shard, n)
        keep = (dst >= lo) & (dst < hi)
        # drop_loops=False: local dst ids numerically colliding with global
        # src ids are NOT self loops
        sub = from_edges(n, src[keep], dst[keep] - lo,
                         dedup=True, drop_loops=False)
        per_shard.append(build_bvss(sub, sigma=sigma))
    num_vss_pad = max(max(b.num_vss for b in per_shard), 1)
    D = n_shards
    masks = np.zeros((D, num_vss_pad, LANES), np.uint32)
    row_ids = np.full((D, num_vss_pad, spw, LANES), rows_per_shard, np.int32)
    # pad VSS entries keep set id 0: their masks are all-zero, so a level
    # whose frontier touches set 0 enqueues them as exact no-op pulls
    v2r = np.zeros((D, num_vss_pad), np.int32)
    # per-shard GLOBAL vertex -> LOCAL VSS range: columns are global in
    # every shard block, so each per-shard real_ptrs spans all n_sets and
    # the map mirrors to_device's vss_of_vertex_start/end per shard
    vss_start = np.zeros((D, n + 1), np.int32)
    vss_end = np.zeros((D, n + 1), np.int32)
    verts = np.arange(n, dtype=np.int64)
    sets = verts // sigma
    for d, b in enumerate(per_shard):
        vss_start[d, :n] = b.real_ptrs[sets]
        vss_end[d, :n] = b.real_ptrs[sets + 1]
        if b.num_vss == 0:
            continue
        masks[d, :b.num_vss] = b.masks
        rid = b.row_ids.copy()
        rid[rid == b.n] = rows_per_shard           # dummy -> local dummy
        row_ids[d, :b.num_vss] = np.minimum(rid, rows_per_shard)
        v2r[d, :b.num_vss] = b.virtual_to_real
    return ShardedBVSS(n=n, m=g.m, sigma=sigma, n_shards=D,
                       rows_per_shard=rows_per_shard,
                       num_vss_pad=num_vss_pad,
                       n_sets=(n + sigma - 1) // sigma,
                       masks=masks, row_ids=row_ids, virtual_to_real=v2r,
                       vss_start=vss_start, vss_end=vss_end,
                       max_vss_per_set=max(
                           max(b.max_vss_per_set for b in per_shard), 1))


# ---------------------------------------------------------------------------
# 2-D (row × column) sharded BVSS (butterfly partition, DESIGN §2.4)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedBVSS2D:
    """2-D partitioned BVSS: device (i, j) of a ``rows × cols`` mesh owns
    the slices pulling its ROW block of destinations from its COLUMN block
    of frontier words.

    The column partition INTERLEAVES inside row blocks: column block j
    owns, within every row block i, the sources
    ``[i·rps + j·cpb, i·rps + (j+1)·cpb)`` where ``cpb = rps / cols``.
    That makes a row block's fresh frontier words split into ``cols``
    contiguous word segments (``rps`` is aligned to ``32·cols``), so the
    per-level exchange along the row axis moves exactly one segment per
    device — per-device volume shrinks by ``cols`` vs the flat 1-D gather.
    Source ids are relabelled to the column block's LOCAL space
    ``local(v) = (v // rps)·cpb + (v mod rps) − j·cpb`` of size
    ``rows · cpb``; destination rows are LOCAL to the row block (dummy =
    ``rps``).  Blocks stack row-major (block d = i·cols + j) and are
    padded to a common VSS count so one program serves all of them.
    ``rows >= cols`` is required so the local column space covers a row
    block (``rows·cpb >= rps``) — checked at build."""

    n: int
    m: int
    sigma: int
    rows: int
    cols: int
    rows_per_shard: int          # aligned to 32·cols
    cols_per_block: int          # cpb = rows_per_shard // cols
    num_vss_pad: int             # per-block VSS count (padded to common max)
    n_sets_local: int            # LOCAL slice sets = rows·cpb / sigma
    masks: np.ndarray            # (rows·cols, num_vss_pad, LANES) uint32
    row_ids: np.ndarray          # (rows·cols, num_vss_pad, spw, LANES) LOCAL
    virtual_to_real: np.ndarray  # (rows·cols, num_vss_pad) LOCAL set ids
    max_vss_per_set: int

    @property
    def n_blocks(self) -> int:
        return self.rows * self.cols

    @property
    def slices_per_word(self) -> int:
        return 32 // self.sigma

    @property
    def n_frontier_words_local(self) -> int:
        """Per-device frontier words: the device's full COLUMN block,
        ``rows`` segments of ``words_per_colseg`` words each."""
        return self.rows * self.cols_per_block // 32

    @property
    def words_per_colseg(self) -> int:
        """Words one row block contributes to one column block per level —
        the unit the butterfly exchange moves."""
        return self.cols_per_block // 32


def build_sharded_bvss_2d(g: Graph, rows: int, cols: int, sigma: int = 8
                          ) -> ShardedBVSS2D:
    """Partition ``g`` into ``rows × cols`` BVSS blocks (see
    :class:`ShardedBVSS2D` for the ownership contract)."""
    if rows < 1 or cols < 1:
        raise ConfigError(f"2-D shard shape ({rows}, {cols}) must be "
                          f"positive")
    if rows < cols:
        raise ConfigError(
            f"2-D BVSS partition needs rows >= cols, got ({rows}, {cols})"
            f" — the interleaved column blocks must cover a row block")
    n = g.n
    rps = -(-n // rows)
    align = 32 * cols  # column segments land on frontier-word boundaries
    rps = ((rps + align - 1) // align) * align
    cpb = rps // cols
    n_loc = rows * cpb              # local column (source) space per block
    spw = 32 // sigma
    src = src_of_edges(g).astype(np.int64)
    dst = g.indices.astype(np.int64)
    soff = src % rps                # offset of each source in its row block
    sblk = src // rps               # row block each source lives in
    per_block: list[BVSS] = []
    for i in range(rows):
        lo, hi = i * rps, min((i + 1) * rps, n)
        in_row = (dst >= lo) & (dst < hi)
        for j in range(cols):
            keep = in_row & (soff // cpb == j)
            lsrc = sblk[keep] * cpb + (soff[keep] - j * cpb)
            # drop_loops=False: relabelled ids colliding are not self loops
            sub = from_edges(n_loc, lsrc, dst[keep] - lo,
                             dedup=True, drop_loops=False)
            per_block.append(build_bvss(sub, sigma=sigma))
    num_vss_pad = max(max(b.num_vss for b in per_block), 1)
    D = rows * cols
    masks = np.zeros((D, num_vss_pad, LANES), np.uint32)
    row_ids = np.full((D, num_vss_pad, spw, LANES), rps, np.int32)
    # pad VSS entries keep set id 0: all-zero masks -> exact no-op pulls
    v2r = np.zeros((D, num_vss_pad), np.int32)
    for d, b in enumerate(per_block):
        if b.num_vss == 0:
            continue
        masks[d, :b.num_vss] = b.masks
        rid = b.row_ids.copy()
        rid[rid == b.n] = rps                      # dummy -> local dummy
        row_ids[d, :b.num_vss] = np.minimum(rid, rps)
        v2r[d, :b.num_vss] = b.virtual_to_real
    return ShardedBVSS2D(n=n, m=g.m, sigma=sigma, rows=rows, cols=cols,
                         rows_per_shard=rps, cols_per_block=cpb,
                         num_vss_pad=num_vss_pad,
                         n_sets_local=n_loc // sigma,
                         masks=masks, row_ids=row_ids, virtual_to_real=v2r,
                         max_vss_per_set=max(
                             max(b.max_vss_per_set for b in per_block), 1))


class ShardedBVSSDevice(NamedTuple):
    """One rank's block of a :class:`ShardedBVSS` (or
    :class:`ShardedBVSS2D`) on the rank's device: the same (masks, row_ids,
    virtual_to_real, vss_of_vertex_start/end) surface the single-device
    engines read from :class:`BVSSDevice`.  One all-zero dummy VSS (index
    ``num_vss_pad``) is appended, its rows mapped to the local dummy level
    slot ``rows_per_shard``.  The reference stacks every shard on a leading
    axis and lets ``shard_map`` strip it; a rank here holds only its own."""

    masks: torch.Tensor            # (num_vss_pad + 1, LANES) int32
    row_ids: torch.Tensor          # (num_vss_pad + 1, spw, LANES) int32
    virtual_to_real: torch.Tensor  # (num_vss_pad + 1,) int32
    # GLOBAL vertex -> LOCAL VSS range (push expansion); named like the
    # BVSSDevice fields so the hybrid step reads one surface in both modes
    vss_of_vertex_start: torch.Tensor  # (n + 1,) int32 ((1,) on 2-D)
    vss_of_vertex_end: torch.Tensor


def _put_block(masks: np.ndarray, row_ids: np.ndarray, v2r: np.ndarray,
               vstart: np.ndarray, vend: np.ndarray, rps: int,
               device: torch.device) -> ShardedBVSSDevice:
    """One block's arrays with the dummy VSS appended, on ``device``."""
    spw = row_ids.shape[1]
    masks = np.concatenate([masks, np.zeros((1, LANES), np.uint32)])
    row_ids = np.concatenate(
        [row_ids, np.full((1, spw, LANES), rps, np.int32)])
    v2r = np.concatenate([v2r, np.zeros(1, np.int32)])

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ShardedBVSSDevice(masks=put(masks.view(np.int32)),
                             row_ids=put(row_ids), virtual_to_real=put(v2r),
                             vss_of_vertex_start=put(vstart),
                             vss_of_vertex_end=put(vend))


def shard_to_device(sb: ShardedBVSS, mesh=None, axis: str = "data", *,
                    shard: int | None = None,
                    device: "str | torch.device | None" = None
                    ) -> ShardedBVSSDevice:
    """Hand one rank its block of ``sb``: shard ``mesh.get_local_rank(axis)``
    on the rank's own device (:func:`~repro_torch.distributed.bfs_dist.
    mesh_rank_device`), with the dummy VSS appended.  Without a mesh,
    ``shard`` and ``device`` say which block goes where."""
    if mesh is not None:
        device = mesh_rank_device(mesh, device)
        shard = mesh.get_local_rank(axis)
    else:
        device = resolve_device(device)
        if shard is None:
            raise ConfigError("shard_to_device needs a mesh or a shard index")
    return _put_block(sb.masks[shard], sb.row_ids[shard],
                      sb.virtual_to_real[shard], sb.vss_start[shard],
                      sb.vss_end[shard], sb.rows_per_shard, device)


def shard_to_device_2d(sb: ShardedBVSS2D, mesh=None, *,
                       shard: int | None = None,
                       device: "str | torch.device | None" = None
                       ) -> ShardedBVSSDevice:
    """2-D twin of :func:`shard_to_device`: device (i, j) of the mesh takes
    block ``i·cols + j`` (row-major).  The 2-D engines are pull-only
    (DESIGN §2.4), so the push-phase vertex -> VSS maps are empty
    placeholders that keep the :class:`ShardedBVSSDevice` surface
    uniform."""
    if mesh is not None:
        device = mesh_rank_device(mesh, device)
        row_axis, col_axis = mesh.mesh_dim_names
        shard = (mesh.get_local_rank(row_axis) * sb.cols
                 + mesh.get_local_rank(col_axis))
    else:
        device = resolve_device(device)
        if shard is None:
            raise ConfigError(
                "shard_to_device_2d needs a mesh or a block index")
    empty = np.zeros(1, np.int32)
    return _put_block(sb.masks[shard], sb.row_ids[shard],
                      sb.virtual_to_real[shard], empty, empty,
                      sb.rows_per_shard, device)
