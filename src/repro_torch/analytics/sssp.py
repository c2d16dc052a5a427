"""Delta-stepping single-source shortest paths on the wave surface
(DESIGN §2.9), the single-device port of ``repro/analytics/sssp.py``.

SSSP is the tropical-semiring instance of the wave machinery: swap the
Boolean pull tile for the min-plus product (CUDA ``bvss_spmm_minplus``)
and BFS levels become weighted distances.  The driver is batched
delta-stepping:

* the OUTER loop owns a per-column bucket top ``btop``; every vertex with
  a settled distance below ``btop`` is final (positive weights);
* the INNER loop relaxes the current bucket to a fixpoint: the frontier
  (vertices whose distance improved and sits below ``btop``) is compacted
  set-wise through the same ``make_compactor`` queue the BFS engines use,
  pulled through the min-plus tiles against the weight plane, and
  scatter-``min``'d into the distance vector;
* the bucket advance jumps ``btop`` to the bucket holding the smallest
  unsettled distance, so empty buckets cost nothing and the bucket width
  shapes only performance, never the answer.

The reference's two nested ``while_loop``s become host loops with the
reference's exact conditions and iteration caps, so both run the same
relaxations: one host copy per relaxation (the live VSS count and the
frontier test) and one per bucket advance.  The scatter-min is
``scatter_reduce_(..., "amin")`` into a distance array with one spare row
for the dummy row id n, which JAX's scatter drops when n is a multiple of
σ.  The sharded builder comes with the mesh slice.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.analytics.common import pad_cohort
from repro_torch.core.bfs import (BlestProblem, make_compactor, queue_widths,
                                  selected_width)
from repro_torch.errors import ConfigError
from repro_torch.kernels import bvss_spmm_minplus_local
from repro_torch.kernels.ref import bvss_spmm_minplus_ref

_INF = float("inf")


def default_delta(weights: np.ndarray) -> float:
    """Bucket width heuristic: the mean edge weight (classic delta-stepping
    uses Δ ≈ mean weight for random weights; correctness never depends on
    the choice — see the module docstring)."""
    w = np.asarray(weights, dtype=np.float64)
    return float(w.mean()) if w.size else 1.0


def _next_btop(rem: torch.Tensor, btop: torch.Tensor,
               delta: torch.Tensor) -> torch.Tensor:
    """Advance each column's bucket top past its smallest unsettled
    distance ``rem`` (jumping empty buckets); columns with no unsettled
    vertex (rem = +inf) keep their top.  ``nextafter`` in float32 guards
    the edge where the bucket formula lands exactly ON ``rem``: the top
    must STRICTLY exceed ``rem`` or the frontier goes empty without
    progress."""
    nbt = (torch.floor(rem / delta) + 1.0) * delta
    nbt = torch.maximum(nbt, torch.nextafter(rem, torch.full_like(rem, _INF)))
    return torch.where(torch.isfinite(rem), nbt, btop)


def make_sssp(problem: BlestProblem, wplane: torch.Tensor, n_sources: int,
              *, use_kernel: bool = True, buckets: int = 2,
              max_rounds: int | None = None) -> Callable:
    """Build ``f(sources (S,), delta float) -> dist (n, S) float32 tensor``
    over ``problem`` (ids are the problem's own).  ``wplane`` is the device
    weight plane ``prepare(..., weights=...)`` committed
    (``PreparedBFS.wplane``); its +inf dummy row makes padded queue entries
    relax nothing.  ``f.stats`` counts relaxations, bucket rounds and host
    copies."""
    if wplane is None:
        raise ConfigError(
            "sssp needs a weight plane: prepare(..., weights=...) or let "
            "GraphSession default to unit weights")
    p = problem
    dev = p.dev
    device = p.device
    n, sigma, n_sets = p.n, p.sigma, p.n_sets
    S = n_sources
    ncols = n_sets * sigma
    widths = queue_widths(p.num_vss, buckets)
    compact = make_compactor(dev, p.num_vss, widths[-1])
    impl = None if use_kernel else bvss_spmm_minplus_ref
    valid = (torch.arange(ncols, device=device) < n)[:, None]  # padding cols
    cap = max_rounds if max_rounds is not None else n + 2
    cols = torch.arange(S, device=device)
    stats = {"relaxations": 0, "rounds": 0, "host_syncs": 0}

    def frontier_queue(fr: torch.Tensor) -> tuple[torch.Tensor, int, bool]:
        """Compact the frontier's slice sets into the VSS queue; one host
        copy brings back the live count and whether the frontier holds
        anything."""
        set_active = fr.view(n_sets, sigma * S).any(dim=1)
        Q, count = compact(set_active)
        count, live = torch.stack([count, fr.any().to(count.dtype)]).tolist()
        stats["host_syncs"] += 1
        return Q, int(count), bool(live)

    def relax(dist: torch.Tensor, fr: torch.Tensor, Q: torch.Tensor,
              count: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One frontier relaxation: compacted min-plus pull + scatter-min.
        Returns (new dist, improved mask)."""
        xg = torch.where(fr, dist, _INF)                 # (ncols, S)
        ids = Q[:selected_width(widths, count)]
        y = bvss_spmm_minplus_local(dev.masks[ids], wplane[ids],
                                    dev.virtual_to_real[ids], xg,
                                    sigma=sigma, impl=impl)
        rows = dev.row_ids[ids].reshape(-1).to(torch.int64)   # dummy = n
        d2 = torch.cat([dist, torch.full((1, S), _INF, device=device)])
        d2.scatter_reduce_(0, rows[:, None].expand(-1, S), y.view(-1, S),
                           "amin")
        # dummy-row scatters may land in padding columns (row n < ncols):
        # wipe them so the padding never re-enters a gather as a distance
        d2 = torch.where(valid, d2[:ncols], _INF)
        stats["relaxations"] += 1
        return d2, d2 < dist

    def sssp(sources, delta: float) -> torch.Tensor:
        srcs = torch.from_numpy(np.asarray(sources, dtype=np.int64)).to(
            device)
        delta = torch.tensor(delta, dtype=torch.float32, device=device)
        dist = torch.full((ncols, S), _INF, device=device)
        dist[srcs, cols] = 0.0
        fr = torch.zeros((ncols, S), dtype=torch.bool, device=device)
        fr[srcs, cols] = True
        btop = delta.expand(S).clone()
        Q, count, live = frontier_queue(fr)
        rounds = 0
        while live and rounds < cap:
            it = 0
            while live and it < cap:
                dist, improved = relax(dist, fr, Q, count)
                fr = improved & (dist < btop[None, :])
                it += 1
                Q, count, live = frontier_queue(fr)
            unsettled = valid & (dist >= btop[None, :])
            rem = torch.where(unsettled, dist, _INF).min(dim=0).values
            nbt = _next_btop(rem, btop, delta)
            fr = unsettled & (dist < nbt[None, :])
            btop = nbt
            rounds += 1
            stats["rounds"] += 1
            Q, count, live = frontier_queue(fr)
        return dist[:n]

    sssp.stats = stats
    return sssp


def sssp_distances(sources: Sequence[int] | np.ndarray, *,
                   problem: BlestProblem, wplane: torch.Tensor,
                   weights: np.ndarray, batch: int | None = None,
                   use_kernel: bool = True,
                   delta: float | None = None,
                   sssp_fn: Callable | None = None) -> np.ndarray:
    """Distances from each source (rows) to every vertex (cols): (S, n)
    float64, +inf where unreachable.  Ids are the problem's own.
    ``sssp_fn`` is an optional prebuilt engine of width ``batch``
    (sessions pass their cached one)."""
    sources = np.asarray(sources, dtype=np.int64)
    if len(sources) == 0:
        return np.zeros((0, problem.n), dtype=np.float64)
    S = batch if batch is not None else min(8, len(sources))
    if delta is None:
        delta = default_delta(weights)
    if sssp_fn is None:
        sssp_fn = make_sssp(problem, wplane, S, use_kernel=use_kernel)
    out = np.empty((len(sources), problem.n), dtype=np.float64)
    for lo in range(0, len(sources), S):
        chunk = sources[lo:lo + S]
        dist = sssp_fn(pad_cohort(chunk, S), delta).cpu().numpy()
        out[lo:lo + len(chunk)] = dist.T[:len(chunk)]
    return out
