"""Brandes betweenness centrality on the BVSS wave engine (DESIGN §2.6),
the single-device port of ``repro/analytics/betweenness.py``.

Brandes' algorithm per source s:

    forward   BFS from s recording levels d(v) and σ(v) shortest-path
              counts: σ(v) = Σ_{u ∈ pred(v)} σ(u);
    backward  dependency accumulation in decreasing level order:
              δ(v) = σ(v) · Σ_{w ∈ succ(v), d(w)=d(v)+1} (1 + δ(w)) / σ(w);
    bc(v)    += δ(v)  for v ≠ s.

Both phases run batched over S stacked sources:

* The FORWARD phase is the fixed-cohort multi-source BFS with the σ
  channel (``make_ms_engine(track_sigma=True)``): each level runs the
  Boolean pull (CUDA ``bvss_spmm``, discovery) plus its weighted twin
  (CUDA ``bvss_spmm_w``) over the same queued tiles, and records the
  per-level VSS queue into a :class:`~repro_torch.core.bfs.QueueHistory`
  (``run_levels_recorded``).

* The BACKWARD phase replays that history in reverse: at level t the
  per-row values h(w) = [d(w)=t] · (1+δ(w))/σ(w) are gathered through
  ``row_ids`` and contracted by the transposed tile product (CUDA
  ``bvss_spmm_t``), then scattered into the slice-set columns and folded
  into δ at level t-1.

The reference's two on-device loops become host loops here, as the level
loop of ``core/bfs.py`` did: one host copy per forward level, one for the
deepest level before the backward sweep.  The scatters into rows and
columns are ``index_add_``s, whose float adds the card orders differently
from run to run; σ stays exact (integers in f32), δ agrees to rtol 1e-5.
The sharded builders come with the mesh slice.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.analytics.common import pad_cohort
from repro_torch.core.bfs import (BlestProblem, QueueHistory,
                                  make_queue_history, queue_widths)
from repro_torch.core.level_pipeline import LevelPipeline, run_levels_recorded
from repro_torch.core.multi_source import INF, make_ms_engine
from repro_torch.graphs import Graph
from repro_torch.kernels import bvss_spmm_t, bvss_spmm_t_local
from repro_torch.kernels.ref import bvss_spmm_t_ref


def make_betweenness(problem: BlestProblem, n_sources: int, *,
                     use_kernel: bool = True, buckets: int = 2,
                     max_levels: int | None = None,
                     spmm_w_impl: Callable | None = None) -> Callable:
    """Build ``f(sources (S,)) -> (levels (n,S) int32, sigma (n,S) f32,
    delta (n,S) f32)`` tensors on the problem's device, running both
    Brandes phases.

    ``delta[:, j]`` is the dependency of every vertex on source ``j``
    (endpoints excluded: the source row is zeroed), so a caller sums
    columns over its source set to get partial betweenness.
    ``max_levels`` bounds the forward levels (default n + 1).
    ``spmm_w_impl`` overrides the weighted tile product — the σ-channel
    seam (DESIGN §2.7).  ``f.engine`` is the forward wave engine (its
    ``stats`` count levels and host copies) and ``f.stats`` counts the
    backward levels."""
    p = problem
    S = n_sources
    n, sigma = p.n, p.sigma
    dev = p.dev
    device = p.device
    eng = make_ms_engine(p, S, use_kernel=use_kernel, buckets=buckets,
                         track_sigma=True, spmm_w_impl=spmm_w_impl)
    spmm_t = bvss_spmm_t if use_kernel else bvss_spmm_t_ref
    widths = queue_widths(p.num_vss, buckets)
    max_lv = max_levels if max_levels is not None else n + 1
    n_cols = p.n_sets * sigma
    col_ids = torch.arange(sigma, device=device)
    cols_idx = torch.arange(S, device=device)
    pipe = LevelPipeline(step=lambda s, lvl: eng.step(s),
                         finalize=lambda s, lvl: eng.finalize(s),
                         active=lambda s: s.cont)
    stats = {"backward_levels": 0, "host_syncs": 0}

    def backward(levels: torch.Tensor, sig: torch.Tensor,
                 hist: QueueHistory) -> torch.Tensor:
        """Reverse per-level sweep over the recorded forward queues."""
        delta = torch.zeros((n, S), dtype=torch.float32, device=device)
        if n == 0:
            return delta
        tmax = int(torch.where(levels == INF, 0, levels).max())
        stats["host_syncs"] += 1
        safe = sig.clamp_min(1.0)
        h = torch.zeros((n + 1, S), dtype=torch.float32, device=device)
        for t in range(tmax, 0, -1):
            Q = hist.Q[t - 1]
            h[:n] = torch.where(levels == t, (1.0 + delta) / safe, 0.0)
            part = bvss_spmm_t_local(dev.masks[Q], dev.row_ids[Q], h,
                                     sigma=sigma, impl=spmm_t)  # (w, σ, S)
            cols = (dev.virtual_to_real[Q].to(torch.int64)[:, None] * sigma
                    + col_ids)
            coeff = torch.zeros((n_cols, S), dtype=torch.float32,
                                device=device)
            coeff.index_add_(0, cols.reshape(-1), part.view(-1, S))
            delta = delta + torch.where(levels == t - 1, sig * coeff[:n],
                                        0.0)
            stats["backward_levels"] += 1
        return delta

    def bc(sources) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        srcs = np.asarray(sources, dtype=np.int64)
        hist0, record = make_queue_history(widths)
        st, _, hist = run_levels_recorded(
            pipe, eng.init(srcs), max_levels=max_lv, history=hist0,
            record=record)
        levels = st.levels[:n]
        delta = backward(levels, st.paths, hist)
        # endpoints excluded: a source contributes no dependency to itself
        delta[torch.from_numpy(srcs).to(device), cols_idx] = 0.0
        return levels, st.paths, delta

    bc.engine = eng
    bc.stats = stats
    return bc


def betweenness_centrality(g: Graph | None,
                           sources: Sequence[int] | np.ndarray, *,
                           problem: BlestProblem | None = None,
                           use_kernel: bool = True,
                           batch: int | None = None,
                           max_levels: int | None = None,
                           bc_fn: Callable | None = None,
                           device: "str | torch.device | None" = None
                           ) -> np.ndarray:
    """Partial Brandes betweenness Σ_{s∈sources} δ_s(v), unnormalised —
    the quantity ``kernels.ref.betweenness_brandes_ref`` computes.

    ``sources`` are ids of ``g`` (or of the prepared graph when
    ``problem`` is passed); duplicates contribute once each.  Sources are
    processed in fixed cohorts of ``batch`` stacked wave columns (default
    min(8, len(sources))); a tail cohort is padded by repeating its last
    source and the padded columns dropped.  ``bc_fn`` is an optional
    prebuilt :func:`make_betweenness` callable of width ``batch``
    (sessions pass their cached one).  Without ``problem`` one is built
    from ``g`` on ``device`` (default: the card)."""
    if problem is None:
        from repro_torch.core.bvss import build_bvss
        problem = BlestProblem.build(build_bvss(g), device)
    sources = np.asarray(sources, dtype=np.int64)
    if len(sources) == 0:
        return np.zeros(problem.n, dtype=np.float64)
    S = batch if batch is not None else min(8, len(sources))
    f = bc_fn if bc_fn is not None else make_betweenness(
        problem, S, use_kernel=use_kernel, max_levels=max_levels)
    bc = np.zeros(problem.n, dtype=np.float64)
    for lo in range(0, len(sources), S):
        chunk = sources[lo:lo + S]
        valid = len(chunk)
        _, _, delta = f(pad_cohort(chunk, S))
        bc += delta[:, :valid].cpu().numpy().astype(np.float64).sum(axis=1)
    return bc
