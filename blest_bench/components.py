"""Edges of each vertex's connected component, for the traversed-edge count.

A root's search traverses its whole component, so the edges it traverses
are the undirected edges of that component (Graph 500's TEPS numerator,
here without self-loops and repeats).  Worked out once a run from the
benchmark's own edge list, never from the program's answers.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


def edges_of_component(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``(n,)`` int64: the undirected edges in each vertex's component."""
    adj = coo_matrix((np.ones(len(a), dtype=np.int8), (a, b)), shape=(n, n))
    _, label = connected_components(adj, directed=False)
    per_label = np.bincount(label[a], minlength=int(label.max()) + 1)
    return per_label[label].astype(np.int64)
