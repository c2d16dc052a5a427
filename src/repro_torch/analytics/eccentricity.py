"""Eccentricity, diameter and radius via batched wave sweeps (DESIGN §2.6),
the port of ``repro/analytics/eccentricity.py``.

The eccentricity of v is the max *finite* BFS distance from v (so it is
well-defined per component; isolated vertices get 0).  A batch of
eccentricity queries is one fixed-cohort multi-source run: S sources
stacked as wave columns through the fused BVSS bit-SpMM engine
(``make_multi_source_bfs``), one level array per column, ecc = max finite
level — S adjacency-sharing BFSs for the price of one sweep.

Diameter/radius use the iFUB scheme (the basis of NetworkX's exact
diameter): a double sweep from a high-degree vertex finds a far vertex r
and a diameter lower bound; then the BFS fringes of r are processed in
DECREASING depth order, batching each fringe through the multi-source
engine, until lb > 2·i proves no unevaluated vertex (all at depth ≤ i)
can route a longer shortest path.  On the
benchmark families this certifies the exact diameter after evaluating a
small fraction of vertices; an eval budget turns the result into
explicit (lb, ub) bounds.  iFUB's termination argument needs symmetry —
hand it a symmetrised problem (``GraphSession.extremes`` does).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.analytics.common import host_levels, pad_cohort
from repro_torch.core.bfs import BlestProblem
from repro_torch.core.multi_source import INF, make_multi_source_bfs
from repro_torch.graphs import Graph


def _ecc_fn(problem: BlestProblem, batch: int, use_kernel: bool,
            levels_fn: Callable | None = None) -> Callable:
    f = levels_fn if levels_fn is not None else make_multi_source_bfs(
        None, batch, problem=problem, use_kernel=use_kernel)

    def ecc_batch(sources: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(eccs, levels) of one padded cohort; levels (n, S) int32."""
        levels = host_levels(f(np.asarray(sources, dtype=np.int64)))
        finite = np.where(levels != INF, levels, 0)
        return finite.max(axis=0).astype(np.int64), levels

    return ecc_batch


def eccentricities(sources: Sequence[int] | np.ndarray, *,
                   g: Graph | None = None,
                   problem: BlestProblem | None = None,
                   batch: int = 8, use_kernel: bool = True,
                   levels_fn: Callable | None = None,
                   device: "str | torch.device | None" = None
                   ) -> np.ndarray:
    """Eccentricity of each source (ids of ``g``/``problem``), processed
    in fixed cohorts of ``batch`` stacked wave columns.  Pass a symmetric
    graph/problem for the classical undirected definition (otherwise this
    is out-eccentricity).  ``levels_fn`` is an optional prebuilt
    fixed-cohort multi-source ``f(sources (batch,)) -> levels (n, batch)``
    over the same problem (sessions pass their cached one; its width must
    equal ``batch``).  Without either, the problem is built from ``g`` on
    ``device`` (default: the card)."""
    if problem is None and levels_fn is None:
        from repro_torch.core.bvss import build_bvss
        problem = BlestProblem.build(build_bvss(g), device)
    sources = np.asarray(sources, dtype=np.int64)
    if len(sources) == 0:
        return np.zeros(0, dtype=np.int64)
    S = batch if levels_fn is not None else min(batch, len(sources))
    ecc_batch = _ecc_fn(problem, S, use_kernel, levels_fn)
    out = np.empty(len(sources), dtype=np.int64)
    for lo in range(0, len(sources), S):
        chunk = sources[lo:lo + S]
        valid = len(chunk)
        out[lo:lo + valid] = ecc_batch(pad_cohort(chunk, S))[0][:valid]
    return out


@dataclasses.dataclass(frozen=True)
class ExtremesReport:
    """iFUB result: exact when ``diameter_lb == diameter_ub``."""

    diameter_lb: int
    diameter_ub: int
    radius_ub: int        # min eccentricity among evaluated vertices
    center: int           # vertex achieving radius_ub
    periphery: int        # vertex achieving diameter_lb's eccentricity
    n_ecc_evals: int      # BFS-equivalents spent (each = one wave column)

    @property
    def exact(self) -> bool:
        return self.diameter_lb == self.diameter_ub

    @property
    def diameter(self) -> int:
        """The certified diameter (raises if only bounds are known)."""
        if not self.exact:
            raise ValueError(
                f"diameter not certified: bounds "
                f"[{self.diameter_lb}, {self.diameter_ub}]")
        return self.diameter_lb


def ifub_extremes(g: Graph | None = None, *,
                  problem: BlestProblem | None = None,
                  start: int | None = None, batch: int = 8,
                  use_kernel: bool = True, max_evals: int | None = None,
                  levels_fn: Callable | None = None,
                  device: "str | torch.device | None" = None
                  ) -> ExtremesReport:
    """iFUB diameter (+ radius upper bound) of ``start``'s component.

    ``start`` defaults to a max-degree vertex (needs ``g``; pass an
    explicit ``start`` when handing only a ``problem``).  ``max_evals``
    caps eccentricity evaluations; when exhausted the report carries
    bounds instead of a certified diameter.  Without ``problem`` or
    ``levels_fn``, the symmetrised problem is built from ``g`` on
    ``device`` (default: the card).
    """
    if problem is None and levels_fn is None:
        from repro_torch.core.bvss import build_bvss
        gs = g.symmetrized
        problem = BlestProblem.build(build_bvss(gs), device)
        g = gs
    if start is None:
        if g is None:
            raise ValueError("need g (for the degree seed) or start")
        start = int(np.argmax(g.out_degree + g.in_degree))
    S = batch
    ecc_batch = _ecc_fn(problem, S, use_kernel, levels_fn)

    def pad(chunk: np.ndarray) -> np.ndarray:
        return pad_cohort(chunk, S)

    # double sweep: ecc(start), then BFS from a farthest vertex r
    eccs, levels = ecc_batch(pad(np.array([start])))
    ecc_u = int(eccs[0])
    finite_u = np.where(levels[:, 0] != INF, levels[:, 0], -1)
    r = int(np.argmax(finite_u))
    eccs, levels = ecc_batch(pad(np.array([r])))
    ecc_r = int(eccs[0])
    lr = levels[:, 0]

    lb = max(ecc_u, ecc_r)
    best_ecc = {start: ecc_u, r: ecc_r}
    evals = 2
    i = ecc_r
    budget_hit = False
    # invariant at the top of each iteration: every vertex DEEPER than i
    # (in the BFS from r) has been evaluated, so any pair routed through a
    # not-yet-evaluated vertex is bounded by 2·i — once lb beats that, lb
    # is the certified diameter
    while i >= 1 and lb <= 2 * i:
        fringe = np.flatnonzero(lr == i)
        for lo in range(0, len(fringe), S):
            chunk = fringe[lo:lo + S]
            valid = len(chunk)
            es = ecc_batch(pad(chunk))[0][:valid]
            for v, e in zip(chunk, es):
                best_ecc[int(v)] = int(e)
            lb = max(lb, int(es.max()))
            evals += valid
            if max_evals is not None and evals >= max_evals:
                budget_hit = True
                break
        if budget_hit:
            break
        i -= 1
    # unevaluated vertices sit at depth <= i (i reached 0 => none beyond
    # r itself, which is evaluated), so max(lb, 2·i) is always a sound
    # upper bound — and equals lb exactly when certification held
    ub = max(lb, 2 * i)
    radius_ub = min(best_ecc.values())
    center = min(best_ecc, key=lambda v: (best_ecc[v], v))
    periphery = max(best_ecc, key=lambda v: (best_ecc[v], -v))
    return ExtremesReport(diameter_lb=lb, diameter_ub=ub,
                          radius_ub=radius_ub, center=center,
                          periphery=periphery, n_ecc_evals=evals)
