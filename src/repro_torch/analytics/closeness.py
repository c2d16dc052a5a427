"""Closeness centrality by reducing wave distance channels (DESIGN §2.6),
the port of ``repro/analytics/closeness.py``.

Closeness is the purest wave client: a batch of sources is one
fixed-cohort multi-source run (S stacked bit-SpMM columns through the
fused BVSS engine), and each column's closeness is a reduction of its
level channel —

    c(s) = (reach(s) - 1) / Σ_{v reachable} d(s, v)

with c(s) = 0 when s reaches nothing (isolated vertices), distances taken
OUTWARD over the problem as given (symmetrise first for the classical
undirected definition; on a symmetric problem this equals NetworkX's
``closeness_centrality(G, wf_improved=False)``).  ``wf_improved`` applies
the Wasserman–Faust scaling ``(reach - 1) / (n - 1)``, which makes scores
comparable across components (NetworkX's default).

*Exact* closeness (``sources=None``) evaluates every vertex — n BFS
columns in cohorts of ``batch``; *sampled* closeness evaluates only the
given pivots (the paper §7 use case: the scores of a source sample).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.analytics.common import host_levels, pad_cohort
from repro_torch.core.bfs import BlestProblem
from repro_torch.core.multi_source import INF, make_multi_source_bfs
from repro_torch.graphs import Graph


def closeness_from_levels(levels: np.ndarray, *,
                          wf_improved: bool = False) -> np.ndarray:
    """Reduce one cohort's ``(n, S)`` wave level channel to the S source
    columns' closeness scores (float64)."""
    levels = np.asarray(levels)
    n = levels.shape[0]
    finite = levels != INF
    dist_sum = np.where(finite, levels, 0).sum(axis=0).astype(np.float64)
    reach = finite.sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        cc = np.where(dist_sum > 0, (reach - 1) / dist_sum, 0.0)
    if wf_improved and n > 1:
        cc = cc * (reach - 1) / (n - 1)
    return cc


def closeness_centrality(g: Graph | None = None,
                         sources: Sequence[int] | np.ndarray | None = None,
                         *,
                         problem: BlestProblem | None = None,
                         batch: int | None = None,
                         use_kernel: bool = True,
                         wf_improved: bool = False,
                         levels_fn: Callable | None = None,
                         device: "str | torch.device | None" = None
                         ) -> np.ndarray:
    """Closeness centrality, exact or sampled.

    ``sources=None`` evaluates EVERY vertex (exact closeness, one score
    per vertex in id order); otherwise one score per given source,
    aligned.  Ids are those of ``g`` / ``problem``.  ``levels_fn`` is an
    optional prebuilt fixed-cohort multi-source
    ``f(sources (batch,)) -> levels (n, batch)`` over the same problem
    (sessions pass their cached one; its width must equal ``batch``).
    Without either, the problem is built from ``g`` on ``device``
    (default: the card).
    """
    if problem is None and levels_fn is None:
        from repro_torch.core.bvss import build_bvss
        if g is None:
            raise ValueError("need one of g / problem / levels_fn")
        problem = BlestProblem.build(build_bvss(g), device)
    if sources is None:
        if problem is not None:
            n = problem.n
        elif g is not None:
            n = g.n
        else:
            raise ValueError("exact closeness (sources=None) needs the "
                             "vertex count: pass g or problem")
        sources = np.arange(n, dtype=np.int64)
    sources = np.asarray(sources, dtype=np.int64)
    if len(sources) == 0:
        return np.zeros(0, dtype=np.float64)
    S = batch if batch is not None else min(8, len(sources))
    if levels_fn is None:
        levels_fn = make_multi_source_bfs(None, S, problem=problem,
                                          use_kernel=use_kernel)
    out = np.empty(len(sources), dtype=np.float64)
    for lo in range(0, len(sources), S):
        chunk = sources[lo:lo + S]
        valid = len(chunk)
        levels = host_levels(levels_fn(pad_cohort(chunk, S)))
        out[lo:lo + valid] = closeness_from_levels(
            levels, wf_improved=wf_improved)[:valid]
    return out
