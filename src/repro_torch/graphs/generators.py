"""Synthetic graph generators covering the paper's benchmark families
(a NumPy-only copy of ``repro/graphs/generators.py``: same seeds, same
graphs).

The paper evaluates on (i) social-like / scale-free graphs (GAP-twitter,
GAP-kron, com-Friendster, web crawls) and (ii) non-social high-diameter
graphs (GAP-road, europe_osm, delaunay, rgg).  We provide generators for
both regimes plus degenerate shapes used by property tests.
"""
from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges


def rmat(n_log2: int, avg_degree: int = 16, *, a=0.57, b=0.19, c=0.19,
         seed: int = 0) -> Graph:
    """R-MAT / Kronecker-style scale-free digraph (GAP-kron regime)."""
    n = 1 << n_log2
    m = n * avg_degree
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(n_log2):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        src_bit = (r >= a + b).astype(np.int64)
        dst_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return from_edges(n, src, dst)


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> Graph:
    """Uniform random digraph (GAP-urand regime)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return from_edges(n, src, dst)


def grid2d(rows: int, cols: int, *, seed: int = 0, shuffle: bool = False) -> Graph:
    """4-neighbour grid digraph, both directions (road-network regime).

    With ``shuffle=True`` the natural (bandwidth-friendly) labelling is
    destroyed, which is the regime where RCM reordering pays off.
    """
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    src, dst = [], []
    right = (idx[:, :-1].ravel(), idx[:, 1:].ravel())
    down = (idx[:-1, :].ravel(), idx[1:, :].ravel())
    for s, d in (right, down):
        src.append(s); dst.append(d)
        src.append(d); dst.append(s)
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    if shuffle:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    return from_edges(n, src, dst)


def star(n: int, out_hub: bool = True) -> Graph:
    """Star graph: hub 0 connected to all others (vsp_msc-like regime)."""
    others = np.arange(1, n, dtype=np.int64)
    hub = np.zeros(n - 1, dtype=np.int64)
    if out_hub:
        src = np.concatenate([hub, others])
        dst = np.concatenate([others, hub])
    else:
        src, dst = others, hub
    return from_edges(n, src, dst)


def path(n: int, bidirectional: bool = True) -> Graph:
    src = np.arange(n - 1, dtype=np.int64)
    dst = src + 1
    if bidirectional:
        return from_edges(n, np.concatenate([src, dst]),
                          np.concatenate([dst, src]))
    return from_edges(n, src, dst)


def random_digraph(n: int, m: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    return from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m))


def clustered(n_clusters: int, cluster_size: int, p_in: float = 0.4,
              p_out: float = 0.005, seed: int = 0) -> Graph:
    """Planted-partition graph: strong communities (Jaccard-ordering regime)."""
    n = n_clusters * cluster_size
    rng = np.random.default_rng(seed)
    src, dst = [], []
    m_in = int(p_in * cluster_size * cluster_size)
    for c in range(n_clusters):
        base = c * cluster_size
        src.append(rng.integers(base, base + cluster_size, m_in))
        dst.append(rng.integers(base, base + cluster_size, m_in))
    m_out = int(p_out * n * 10)
    src.append(rng.integers(0, n, m_out))
    dst.append(rng.integers(0, n, m_out))
    g = from_edges(n, np.concatenate(src), np.concatenate(dst))
    # shuffle labels so orderings have work to do
    perm = rng.permutation(n)
    return g.permute_fast(perm)


def rgg2d(n: int, radius: float | None = None, seed: int = 0) -> Graph:
    """Random geometric graph on the unit square (rgg_24 regime)."""
    rng = np.random.default_rng(seed)
    if radius is None:
        radius = 1.8 / np.sqrt(n)
    pts = rng.random((n, 2))
    # grid binning for near-linear neighbour search
    cell = radius
    nbins = max(1, int(1.0 / cell))
    bx = np.minimum((pts[:, 0] / cell).astype(np.int64), nbins - 1)
    by = np.minimum((pts[:, 1] / cell).astype(np.int64), nbins - 1)
    bin_id = bx * nbins + by
    order = np.argsort(bin_id, kind="stable")
    src_l, dst_l = [], []
    sorted_bin = bin_id[order]
    starts = np.searchsorted(sorted_bin, np.arange(nbins * nbins))
    ends = np.searchsorted(sorted_bin, np.arange(nbins * nbins), side="right")
    for gx in range(nbins):
        for gy in range(nbins):
            b = gx * nbins + gy
            mine = order[starts[b]:ends[b]]
            if len(mine) == 0:
                continue
            cand = [mine]
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    if dx == 0 and dy == 0:
                        continue
                    nx, ny = gx + dx, gy + dy
                    if 0 <= nx < nbins and 0 <= ny < nbins:
                        nb = nx * nbins + ny
                        cand.append(order[starts[nb]:ends[nb]])
            cand = np.concatenate(cand)
            d2 = ((pts[mine, None, :] - pts[None, cand, :]) ** 2).sum(-1)
            ii, jj = np.nonzero(d2 <= radius * radius)
            s, d = mine[ii], cand[jj]
            keep = s != d
            src_l.append(s[keep]); dst_l.append(d[keep])
    if not src_l:
        return from_edges(n, np.array([], dtype=np.int64),
                          np.array([], dtype=np.int64))
    return from_edges(n, np.concatenate(src_l), np.concatenate(dst_l))
