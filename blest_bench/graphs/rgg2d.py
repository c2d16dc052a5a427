"""Random geometric graph in the unit square (the DIMACS10 ``rgg_n_2_*_s0`` rule).

``2**scale`` points uniform in the unit square; an undirected edge joins two
points closer than ``radius_factor * sqrt(ln n / n)`` (DIMACS10: 0.55).
Vectorised over a grid of cells at least one radius wide, so only points in
the same or an adjacent cell are compared, each pair once.
"""
from __future__ import annotations

import numpy as np

#: the size that the harness's CPU tests give every configuration of this
#: family, merged over its parameters (``tiny.make_root``)
TINY = {"scale": 6}

# the cell itself, then the four neighbours that make every adjacent pair
# of cells appear exactly once
_OFFSETS = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def edge_tuples(params: dict, rng: np.random.Generator
                ) -> tuple[int, np.ndarray, np.ndarray]:
    """``(n, u, v)``: every pair closer than the radius, once, ``u != v``."""
    n = 1 << int(params["scale"])
    radius = float(params["radius_factor"]) * np.sqrt(np.log(n) / n)
    pts = rng.random((n, 2))
    cells = max(1, int(np.floor(1.0 / radius)))
    cxy = np.minimum((pts * cells).astype(np.int64), cells - 1)
    cell = cxy[:, 0] * cells + cxy[:, 1]
    order = np.argsort(cell, kind="stable")
    pts, cxy, cell = pts[order], cxy[order], cell[order]
    start = np.searchsorted(cell, np.arange(cells * cells + 1))
    r2 = radius * radius
    us, vs = [], []
    idx = np.arange(n, dtype=np.int64)
    for dx, dy in _OFFSETS:
        nx, ny = cxy[:, 0] + dx, cxy[:, 1] + dy
        ok = (nx >= 0) & (nx < cells) & (ny >= 0) & (ny < cells)
        nc = np.where(ok, nx * cells + ny, 0)
        lo = np.where(ok, start[nc], 0)
        hi = np.where(ok, start[nc + 1], 0)
        if dx == 0 and dy == 0:
            lo = idx + 1                 # same cell: each pair once
        cnt = np.maximum(hi - lo, 0)
        i = np.repeat(idx, cnt)
        first = np.cumsum(cnt) - cnt
        j = np.repeat(lo, cnt) + (np.arange(len(i)) - np.repeat(first, cnt))
        d = pts[i] - pts[j]
        near = (d * d).sum(axis=1) < r2
        us.append(i[near])
        vs.append(j[near])
    # back to the points' draw order, so a point's id is its draw index
    return n, order[np.concatenate(us)], order[np.concatenate(vs)]
