"""The plain reference: breadth-first search levels in NumPy.

It reads the benchmark's own edge list and nothing the program made (no
ordering, permutation, BVSS or kernel twin).  Levels are int32 hop counts
from the root, ``INF`` (int32 max) where the root does not reach: what
``GraphSession.levels_batch`` and ``GraphSession.levels`` promise in the
caller's vertex ids.

``control=True`` builds the comparison's control: the same search with one
guarantee of the configuration broken: each edge ``(a, b)``, ``a < b``,
followed from ``a`` to ``b`` only (the graph taken as directed).
"""
from __future__ import annotations

import numpy as np

INF = np.iinfo(np.int32).max


def csr(n: int, a: np.ndarray, b: np.ndarray, *, control: bool = False
        ) -> tuple[np.ndarray, np.ndarray]:
    """Adjacency lists of the undirected graph (``control``: ``a -> b`` only)."""
    src = a if control else np.concatenate([a, b])
    dst = b if control else np.concatenate([b, a])
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, np.asarray(dst, dtype=np.int64)[order]


def bfs_levels(indptr: np.ndarray, indices: np.ndarray, root: int
               ) -> np.ndarray:
    """Levels of every vertex from ``root``, one frontier at a time."""
    n = len(indptr) - 1
    levels = np.full(n, INF, dtype=np.int32)
    levels[root] = 0
    frontier = np.array([root], dtype=np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        first = np.cumsum(counts) - counts
        at = np.repeat(starts - first, counts) + np.arange(total)
        nbrs = indices[at]
        frontier = np.unique(nbrs[levels[nbrs] == INF])
        levels[frontier] = depth
    return levels


def wrong_vertices(answer, expected: np.ndarray) -> int:
    """Vertices whose level differs; an answer of another shape is wrong
    everywhere."""
    got = np.asarray(answer) if answer is not None else None
    if got is None or got.shape != expected.shape:
        return int(expected.size)
    return int(np.count_nonzero(got.astype(np.int64) != expected))
