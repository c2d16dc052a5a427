"""Graph containers (a NumPy-only copy of ``repro/graphs/csr.py``).

A ``Graph`` stores a simple directed graph in CSR (out-neighbour) form and
lazily materialises the in-neighbour (CSC / transposed CSR) view that the
pull-based BFS pipeline consumes.  All construction is host-side NumPy; the
device-facing structures (BVSS, bit-adjacency) are built from these arrays.

Construction VALIDATES the CSR invariants (shape, monotone ``indptr``,
in-range ``indices``, integer dtypes) and raises
:class:`repro_torch.errors.GraphValidationError` with a descriptive message —
not a bare ``assert``, so a malformed graph is rejected even under
``python -O`` (DESIGN §2.7).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from repro_torch.errors import GraphValidationError


@dataclasses.dataclass(frozen=True)
class Graph:
    """Simple directed graph, CSR over out-neighbours."""

    n: int
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (m,)  int32, out-neighbour lists, sorted per row

    def __post_init__(self):
        if not isinstance(self.n, (int, np.integer)) or self.n < 0:
            raise GraphValidationError(
                f"vertex count n must be a non-negative integer, got "
                f"{self.n!r}")
        indptr = np.asarray(self.indptr)
        indices = np.asarray(self.indices)
        if not np.issubdtype(indptr.dtype, np.integer):
            raise GraphValidationError(
                f"indptr must be an integer array, got dtype {indptr.dtype}")
        if not np.issubdtype(indices.dtype, np.integer):
            raise GraphValidationError(
                f"indices must be an integer array, got dtype "
                f"{indices.dtype}")
        if indptr.shape != (self.n + 1,):
            raise GraphValidationError(
                f"indptr has shape {indptr.shape}, expected ({self.n + 1},) "
                f"for a graph with n={self.n} vertices")
        if indptr[0] != 0:
            raise GraphValidationError(
                f"indptr[0] must be 0, got {int(indptr[0])}")
        if indptr[-1] != len(indices):
            raise GraphValidationError(
                f"indptr[-1]={int(indptr[-1])} does not match "
                f"len(indices)={len(indices)}")
        if len(indptr) > 1 and (np.diff(indptr) < 0).any():
            bad = int(np.flatnonzero(np.diff(indptr) < 0)[0])
            raise GraphValidationError(
                f"indptr must be non-decreasing; decreases at row {bad} "
                f"({int(indptr[bad])} -> {int(indptr[bad + 1])})")
        if len(indices) and (int(indices.min()) < 0
                             or int(indices.max()) >= self.n):
            bad_vals = indices[(indices < 0) | (indices >= self.n)]
            raise GraphValidationError(
                f"indices contain out-of-range vertex ids "
                f"{bad_vals[:8].tolist()} (valid ids are 0..{self.n - 1})")

    @property
    def m(self) -> int:
        return int(len(self.indices))

    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n).astype(np.int64)

    def neighbours(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    # -- transposed (in-neighbour) view: row u of A^T = incoming edges of u --
    @cached_property
    def t_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR of the transposed graph: (indptr, indices)."""
        order = np.argsort(self.indices, kind="stable")
        t_indices = src_of_edges(self)[order].astype(np.int32)
        counts = np.bincount(self.indices, minlength=self.n)
        t_indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=t_indptr[1:])
        return t_indptr, t_indices

    def transpose(self) -> "Graph":
        t_indptr, t_indices = self.t_csr
        return Graph(self.n, t_indptr, t_indices)

    def _check_perm(self, perm: np.ndarray) -> np.ndarray:
        """Validate that ``perm`` is a permutation of 0..n-1."""
        raw = np.asarray(perm)
        if raw.shape != (self.n,):
            raise GraphValidationError(
                f"perm has shape {raw.shape}, expected ({self.n},)")
        if raw.size and not np.issubdtype(raw.dtype, np.integer):
            raise GraphValidationError(
                f"perm must be an integer array, got dtype {raw.dtype}")
        perm = raw.astype(np.int64)
        if self.n:
            oob = ((perm < 0) | (perm >= self.n)).any()
            if oob or (np.bincount(perm if not oob else
                                   np.clip(perm, 0, self.n - 1),
                                   minlength=self.n) != 1).any():
                raise GraphValidationError(
                    "perm is not a permutation of 0..n-1 (duplicate, "
                    "negative or out-of-range entries)")
        return perm

    def permute(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: new id of old vertex v is ``perm[v]``."""
        perm = self._check_perm(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n)
        # Row u of the new graph is row inv[u] of the old one, with relabelled
        # column ids.
        new_deg = self.out_degree[inv]
        new_indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(new_deg, out=new_indptr[1:])
        new_indices = np.empty(self.m, dtype=np.int32)
        for u in range(self.n):
            old = inv[u]
            s, e = self.indptr[old], self.indptr[old + 1]
            seg = perm[self.indices[s:e]]
            seg.sort()
            new_indices[new_indptr[u]:new_indptr[u + 1]] = seg
        return Graph(self.n, new_indptr, new_indices)

    def permute_fast(self, perm: np.ndarray) -> "Graph":
        """Vectorised relabel (equivalent to :meth:`permute`)."""
        perm = self._check_perm(perm)
        src = perm[src_of_edges(self)]
        dst = perm[self.indices.astype(np.int64)]
        return from_edges(self.n, src, dst, dedup=False)

    @cached_property
    def symmetrized(self) -> "Graph":
        src = src_of_edges(self)
        dst = self.indices.astype(np.int64)
        return from_edges(
            self.n, np.concatenate([src, dst]), np.concatenate([dst, src]),
            dedup=True)

    def bandwidth(self) -> int:
        """Max |u - v| over edges (matrix bandwidth of the adjacency)."""
        if self.m == 0:
            return 0
        src = src_of_edges(self)
        return int(np.abs(src - self.indices.astype(np.int64)).max())


def src_of_edges(g: Graph) -> np.ndarray:
    """(m,) array of edge sources aligned with ``g.indices``."""
    return np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))


def from_edges(n: int, src: np.ndarray, dst: np.ndarray, *,
               dedup: bool = True, drop_loops: bool = True) -> Graph:
    """Build a Graph from edge lists (vectorised)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if drop_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    key = src * n + dst
    if dedup:
        key = np.unique(key)
    else:
        key = np.sort(key)
    src = key // n
    dst = key % n
    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(n, indptr, dst.astype(np.int32))

