"""Graph reordering strategies (paper §3.2), a NumPy/SciPy copy of
``repro/core/ordering.py`` (byte-equal permutations).

* :func:`jaccard_windows` — Algorithm 1 (JaccardWithWindows): windowed greedy
  Jaccard clustering of *columns* (vertices as sources) so that vertices with
  common out-neighbours land in the same σ-wide slice set.
* :func:`shingle_order` — cheap similarity pre-pass (stand-in for Gorder [42],
  which is proprietary-complex; shingle/minhash ordering groups vertices with
  common neighbours and is the standard lightweight alternative).  Documented
  deviation: the paper uses Gorder as the pre-pass; we use shingle ordering,
  which optimises the same objective (co-locating Jaccard-similar vertices).
* :func:`rcm` — bandwidth-reducing Reverse Cuthill–McKee for non-social
  graphs (scipy implementation).
* :func:`is_social_like` — the paper's heavy-tail + power-law classifier.
* :func:`auto_order` — the "One Ordering Decision to Pull them All" policy.

All functions return a *permutation* ``perm`` such that the new id of old
vertex v is ``perm[v]`` (apply with ``graph.permute_fast(perm)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from repro_torch.graphs import Graph, src_of_edges


def natural_order(g: Graph) -> np.ndarray:
    return np.arange(g.n, dtype=np.int64)


def random_order(g: Graph, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(g.n).astype(np.int64)


def degree_order(g: Graph, descending: bool = True) -> np.ndarray:
    key = g.out_degree + g.in_degree
    order = np.argsort(-key if descending else key, kind="stable")
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    return perm


def rcm(g: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee on the symmetrised adjacency (paper §3.2.1)."""
    gs = g.symmetrized
    mat = sp.csr_matrix(
        (np.ones(gs.m, dtype=np.int8), gs.indices, gs.indptr), shape=(g.n, g.n))
    order = np.asarray(reverse_cuthill_mckee(mat, symmetric_mode=True))
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    return perm


def shingle_order(g: Graph, seed: int = 0) -> np.ndarray:
    """Minhash/shingle ordering: sort vertices by the minimum (hashed)
    out-neighbour id.  Vertices sharing neighbours get equal shingles and
    become adjacent — a cheap proxy for Gorder's windowed common-neighbour
    objective."""
    rng = np.random.default_rng(seed)
    h = rng.permutation(g.n).astype(np.int64)
    src = src_of_edges(g)
    hashed = h[g.indices.astype(np.int64)]
    shingle = np.full(g.n, g.n, dtype=np.int64)
    np.minimum.at(shingle, src, hashed)
    # secondary shingle breaks ties among vertices with the same min-hash
    h2 = rng.permutation(g.n).astype(np.int64)
    hashed2 = h2[g.indices.astype(np.int64)]
    shingle2 = np.full(g.n, g.n, dtype=np.int64)
    np.minimum.at(shingle2, src, hashed2)
    order = np.lexsort((shingle2, shingle))
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    return perm


def jaccard_windows(g: Graph, sigma: int = 8, w: int = 1024, *,
                    pre_order: np.ndarray | None = None,
                    seed: int = 0) -> np.ndarray:
    """Algorithm 1 (JaccardWithWindows), vectorised.

    Columns (vertices) are clustered greedily inside disjoint windows of
    size ``w``; each cluster of σ vertices becomes one slice set.  Per
    selection we need |N(j) ∩ U| for all remaining candidates j — computed
    incrementally with one sparse matvec per accepted vertex, giving
    O(w · δ) work per selection instead of O(w² · δ) per window.
    ``N(v)`` is the *out*-neighbourhood (the set of rows whose slice the
    column v occupies in A^T).
    """
    assert w % sigma == 0
    n = g.n
    if pre_order is not None:
        g_work = g.permute_fast(pre_order)
    else:
        g_work = g
        pre_order = np.arange(n, dtype=np.int64)

    # CSR over out-neighbours of the (pre-ordered) graph
    A = sp.csr_matrix((np.ones(g_work.m, dtype=np.int32),
                       g_work.indices.astype(np.int64), g_work.indptr),
                      shape=(n, n))
    deg = np.diff(g_work.indptr).astype(np.int64)

    perm_work = np.empty(n, dtype=np.int64)  # new id of pre-ordered vertex
    for ws in range(0, n, w):
        we = min(ws + w, n)
        win = np.arange(ws, we, dtype=np.int64)
        L = len(win)
        S = A[win]                      # (L, n) out-neighbourhoods
        ST = S.T.tocsr()                # (n, L): column v -> windows rows
        remaining = np.ones(L, dtype=bool)
        inter = np.zeros(L, dtype=np.int64)     # |N(j) ∩ U| for current cluster
        in_U = np.zeros(n, dtype=bool)
        pos = ws
        n_clusters = (L + sigma - 1) // sigma
        for _c in range(n_clusters):
            if not remaining.any():
                break
            # seed: first remaining vertex (paper: arbitrary seed)
            j_star = int(np.argmax(remaining))
            remaining[j_star] = False
            perm_work[win[j_star]] = pos
            pos += 1
            # U <- N(j*) ; update intersections for new members of U
            inter[:] = 0
            in_U[:] = False
            new_members = S.indices[S.indptr[j_star]:S.indptr[j_star + 1]]
            if len(new_members):
                in_U[new_members] = True
                inter += np.asarray(ST[new_members].sum(axis=0)).ravel()
            u_size = int(in_U.sum())
            for _r in range(sigma - 1):
                if not remaining.any():
                    break
                union = deg[win] + u_size - inter
                score = np.where(remaining & (union > 0),
                                 inter / np.maximum(union, 1), -1.0)
                # prefer genuinely similar candidates; fall back to any
                j_dag = int(np.argmax(score))
                if not remaining[j_dag]:
                    break
                remaining[j_dag] = False
                perm_work[win[j_dag]] = pos
                pos += 1
                nb = S.indices[S.indptr[j_dag]:S.indptr[j_dag + 1]]
                fresh = nb[~in_U[nb]]
                if len(fresh):
                    in_U[fresh] = True
                    u_size += len(fresh)
                    inter += np.asarray(ST[fresh].sum(axis=0)).ravel()
        # any leftover (empty-degree stragglers) keep window-relative order
        left = np.nonzero(remaining)[0]
        for j in left:
            perm_work[win[j]] = pos
            pos += 1
        assert pos == we

    # compose: old vertex v -> pre_order[v] -> perm_work[pre_order[v]]
    return perm_work[pre_order]


# ---------------------------------------------------------------------------
# social-like classification (paper §3.2.1 decision rule)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SocialLikeReport:
    heavy_tail: bool
    power_law: bool
    top1_share: float
    top10_share: float
    ll_slope: float
    ll_r2: float

    @property
    def is_social(self) -> bool:
        return self.heavy_tail or self.power_law


def social_like_report(g: Graph) -> SocialLikeReport:
    deg = (g.out_degree + g.in_degree).astype(np.float64)
    m2 = deg.sum()
    order = np.sort(deg)[::-1]
    k1 = max(1, g.n // 100)
    k10 = max(1, g.n // 10)
    top1 = order[:k1].sum() / max(m2, 1)
    top10 = order[:k10].sum() / max(m2, 1)
    heavy = (top1 > 0.05) and (top10 > 0.40)

    # log-log degree histogram straight-line fit
    pos = deg[deg > 0].astype(np.int64)
    slope, r2 = 0.0, 0.0
    if len(pos) > 0:
        hist = np.bincount(pos)
        ks = np.nonzero(hist)[0]
        ks = ks[ks > 0]
        if len(ks) >= 5:
            x = np.log(ks.astype(np.float64))
            y = np.log(hist[ks].astype(np.float64))
            A = np.stack([x, np.ones_like(x)], axis=1)
            coef, *_ = np.linalg.lstsq(A, y, rcond=None)
            slope = float(coef[0])
            pred = A @ coef
            ss_res = float(((y - pred) ** 2).sum())
            ss_tot = float(((y - y.mean()) ** 2).sum())
            r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    power = (-4.0 <= slope <= -1.2) and (r2 >= 0.7)
    return SocialLikeReport(heavy_tail=heavy, power_law=power,
                            top1_share=float(top1), top10_share=float(top10),
                            ll_slope=slope, ll_r2=r2)


def is_social_like(g: Graph) -> bool:
    return social_like_report(g).is_social


def auto_order(g: Graph, sigma: int = 8, w: int = 1024,
               seed: int = 0) -> tuple[np.ndarray, str]:
    """Paper §3.2 policy: social-like → shingle pre-pass + JaccardWithWindows
    (compression-oriented); otherwise → RCM (bandwidth/divergence-oriented)."""
    if is_social_like(g):
        pre = shingle_order(g, seed=seed)
        n_up = ((g.n + sigma - 1) // sigma) * sigma
        return jaccard_windows(g, sigma=sigma, w=max(sigma, min(w, n_up)),
                               pre_order=pre, seed=seed), "jaccard_windows"
    return rcm(g), "rcm"
