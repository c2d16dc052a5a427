"""PageRank as a float-channel power iteration on the BVSS tiles
(DESIGN §2.9), the port of ``repro/analytics/pagerank.py``.

The pull form of one PageRank step is exactly the weighted tile product
the σ path-count channel owns (CUDA ``bvss_spmm_w``, at S = 1):

    r'[u] = (1 - d)/n + d · ( Σ_{v→u} r[v] / outdeg[v]  +  dangling/n )

where ``dangling = Σ_{outdeg[v]=0} r[v]`` redistributes the mass of sink
vertices uniformly.  Every iteration pulls the FULL tile stream (PageRank
has no frontier, so the static all-VSS queue replaces the compactor),
scatter-adds through ``row_ids``, applies the damping and dangling terms,
and tests the L1 residual ``Σ|r' - r|`` against ``tol``.

The reference's ``while_loop`` becomes a host loop with one host copy of
the residual per iteration and the same iteration cap.  The scatter-add
is an ``index_add_`` into one spare row for the dummy row id n (which
JAX's ``mode="drop"`` drops when n is a multiple of σ).  It accumulates
in float64 and rounds once to float32: the card orders its atomic adds
differently from run to run, and float32 sums would carry that noise
into every iteration.

A 1-D row-sharded problem runs the same loop on every rank: each rank
keeps its row block of ranks, the contributions ``r / outdeg`` are
all-gathered once an iteration (the float twin of the frontier-word
gather), and the dangling mass and the residual are rank partial sums
all-reduced in float64, so the convergence test is the same on every
rank.  A 2-D problem is a :class:`~repro_torch.errors.ConfigError`, as in
the reference (DESIGN §2.9).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.bfs import BlestProblem, gather_rows, rank_layout
from repro_torch.core.level_pipeline import mesh_reduce
from repro_torch.distributed.collectives import all_gather_tiled
from repro_torch.errors import ConfigError
from repro_torch.graphs import Graph
from repro_torch.kernels import bvss_spmm_w_local
from repro_torch.kernels.ref import bvss_spmm_w_ref

DAMPING = 0.85
TOL = 1e-8
MAX_ITER = 200
_INF = float("inf")


def out_degrees(g: Graph) -> np.ndarray:
    """Out-degree per vertex of ``g`` (float32) — the host-side operand
    PageRank normalises contributions with."""
    return np.diff(g.indptr).astype(np.float32)


def make_pagerank(problem: BlestProblem, outdeg: np.ndarray, *,
                  use_kernel: bool = True, damping: float = DAMPING,
                  tol: float = TOL, max_iter: int = MAX_ITER) -> Callable:
    """Build ``f() -> r (n,) float32 tensor`` over ``problem`` (ids are the
    problem's own; ``outdeg`` in the same id space).  Single-device and
    1-D row-sharded (the answer global on every rank); 2-D raises
    :class:`~repro_torch.errors.ConfigError`.  ``f.stats`` counts
    iterations and host copies."""
    p = problem
    if p.is_2d:
        raise ConfigError(
            "pagerank is not supported on a 2-D (row × column) mesh yet — "
            "the weighted verbs ship 1-D row-sharded (DESIGN §2.9)")
    dev = p.dev
    device = p.device
    n, sigma, n_sets = p.n, p.sigma, p.n_sets
    lay = rank_layout(p)
    # this rank's rows: one device the whole padded column space, a mesh
    # rank its row block (its contributions are all-gathered a step)
    L = n_sets * sigma if p.mesh is None else lay.rows
    impl = None if use_kernel else bvss_spmm_w_ref
    # PageRank has no frontier: the static full queue replaces the
    # compactor.  An edgeless graph has zero VSS — pull the all-zero dummy
    # row so the tile batch is never empty (it contributes nothing)
    Q = torch.arange(max(p.num_vss, 1), device=device)
    masks = dev.masks[Q]
    sets = dev.virtual_to_real[Q]
    rows = dev.row_ids[Q].reshape(-1).to(torch.int64)     # dummy row
    lo, hi = min(lay.first_row, n), min(lay.first_row + L, n)
    deg = torch.zeros(L, dtype=torch.float32, device=device)
    deg[:hi - lo] = torch.from_numpy(
        np.asarray(outdeg, dtype=np.float32)[lo:hi]).to(device)
    valid = (lay.first_row + torch.arange(L, device=device)) < n
    dangling = valid & (deg == 0.0)
    d = torch.tensor(damping, dtype=torch.float32, device=device)
    base = torch.tensor((1.0 - damping) / max(n, 1), dtype=torch.float32,
                        device=device)
    tol32 = float(np.float32(tol))       # the reference compares in f32
    stats = {"iterations": 0, "host_syncs": 0}

    def mesh_sum(x: torch.Tensor) -> torch.Tensor:
        """A rank's partial sum summed over the mesh in float64 (itself on
        one device)."""
        if p.mesh is None:
            return x
        return mesh_reduce(x.to(torch.float64).reshape(1), lay.groups)[0]

    def step(r: torch.Tensor) -> torch.Tensor:
        x = torch.where(deg > 0, r / deg, 0.0)           # (L,)
        if p.mesh is not None:
            x = all_gather_tiled(x, lay.row_group)
        y = bvss_spmm_w_local(masks, sets, x[:, None], sigma=sigma,
                              impl=impl)
        # float64 sums: the card's atomic adds come in a different order
        # every run, and in float32 that noise alone keeps the L1 residual
        # above tol (200 iterations instead of ~21 on rmat(18), PERF.md);
        # rounded once to float32, the sums are the same run to run
        acc = torch.zeros(L + 1, dtype=torch.float64, device=device)
        acc.index_add_(0, rows, y.view(-1).to(torch.float64))
        dm = mesh_sum(torch.where(dangling, r, 0.0).sum()).to(torch.float32)
        return torch.where(valid, base + d * (acc[:L].to(torch.float32)
                                              + dm / n), 0.0)

    def pagerank() -> torch.Tensor:
        r = torch.where(valid, torch.tensor(1.0 / max(n, 1),
                                            dtype=torch.float32,
                                            device=device), 0.0)
        res, it = _INF, 0
        while res > tol32 and it < max_iter:
            r2 = step(r)
            res = float(mesh_sum((r2 - r).abs().sum()))
            stats["host_syncs"] += 1
            r, it = r2, it + 1
        stats["iterations"] += it
        return gather_rows(r, lay, n)

    pagerank.stats = stats
    return pagerank


def pagerank_scores(g: Graph | None = None, *,
                    problem: BlestProblem | None = None,
                    outdeg: np.ndarray | None = None,
                    use_kernel: bool = True, damping: float = DAMPING,
                    tol: float = TOL, max_iter: int = MAX_ITER,
                    pagerank_fn: Callable | None = None,
                    device: "str | torch.device | None" = None
                    ) -> np.ndarray:
    """PageRank scores (n,) float64 summing to 1, ids the problem's own.
    ``pagerank_fn`` is an optional prebuilt engine (sessions pass their
    cached one).  Without ``problem`` one is built from ``g`` on
    ``device`` (default: the card)."""
    if pagerank_fn is None:
        if problem is None:
            from repro_torch.core.bvss import build_bvss
            if g is None:
                raise ValueError("need one of g / problem / pagerank_fn")
            problem = BlestProblem.build(build_bvss(g), device)
        if outdeg is None:
            if g is None:
                raise ValueError("pagerank needs out-degrees: pass g or "
                                 "outdeg")
            outdeg = out_degrees(g)
        pagerank_fn = make_pagerank(problem, outdeg, use_kernel=use_kernel,
                                    damping=damping, tol=tol,
                                    max_iter=max_iter)
    return pagerank_fn().cpu().numpy().astype(np.float64)
