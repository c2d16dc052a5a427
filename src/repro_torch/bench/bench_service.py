"""BVSS multi-source against the dense multi-source baseline, the
``multi_source`` section of ``benchmarks/bench_service.py``::

    PYTHONPATH=src python -m repro_torch.bench.bench_service

Per graph of the suite, the fixed-cohort multi-source engine on the BVSS
bit-SpMM path (``core/multi_source.py``, the ``bvss_spmm`` kernel) against
the dense baseline below (``to_dense_bits`` adjacency + the ``bit_spmm``
kernel), both answers equal, with the adjacency footprint of each (the
dense bitmap is n * ceil(n/32) words; the BVSS scales with slices).  The
``serve`` and ``hardened`` sections need the robust serving tier
(``GraphSessionManager``, ROADMAP.md queue 1 item 7) and are not ported.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.bench.common import fmt_row, geomean, graph_suite
from repro_torch.core.bfs import INF
from repro_torch.core.bvss import resolve_device
from repro_torch.core.multi_source import make_multi_source_bfs
from repro_torch.core.policy import prepare
from repro_torch.errors import KernelFaultError
from repro_torch.graphs import Graph, to_dense_bits
from repro_torch.kernels import bit_spmm


def make_dense_multi_source_bfs(g: Graph, n_sources: int, *,
                                device=None) -> Callable:
    """The dense multi-source baseline ``f(sources (S,)) -> levels (n, S)
    int32 tensor``: each level pulls the (n, S) int8 frontier columns
    through the dense pull adjacency with ``bit_spmm``, ``Y = bits(A) @ X``,
    and marks the rows with a count and no level yet.  A host loop with one
    host copy per level."""
    device = resolve_device(device)
    n, S = g.n, n_sources
    adj = torch.from_numpy(to_dense_bits(g)).to(device)    # (n, ceil(n/32))
    cols = torch.arange(S, device=device)

    def bfs(sources) -> torch.Tensor:
        src = torch.as_tensor(np.asarray(sources, dtype=np.int64),
                              device=device)
        levels = torch.full((n, S), INF, dtype=torch.int32, device=device)
        levels[src, cols] = 0
        X = torch.zeros((n, S), dtype=torch.int8, device=device)
        X[src, cols] = 1
        lvl, active = 0, S > 0
        while active and lvl < n + 1:
            lvl += 1
            new = (bit_spmm(adj, X) > 0) & (levels == INF)
            levels.masked_fill_(new, lvl)
            X = new.to(torch.int8)
            active = bool(new.any())
        return levels

    return bfs


def _median_time(fn, arg, reps: int = 3) -> float:
    """Median seconds per call (after one warm call), each ending in a
    device-to-host copy."""
    fn(arg).cpu()
    ts = []
    for _ in range(reps):
        t0 = time.time()
        fn(arg).cpu()
        ts.append(time.time() - t0)
    return float(np.median(ts))


def run(scale: int = 9, n_queries: int = 8, device=None,
        verbose: bool = True) -> dict:
    """The ``multi_source`` section over :func:`graph_suite`: per graph the
    BVSS and dense times, their ratio and both footprints."""
    device = resolve_device(device)
    graphs_out = {}
    for gname, g in graph_suite(scale).items():
        rng = np.random.default_rng(0)
        prep = prepare(g, device=device, w=512)
        rng.integers(0, g.n, n_queries)   # the reference's serve queries
        S = min(8, n_queries)
        srcs = rng.integers(0, g.n, S)
        internal = prep.perm[srcs]
        f_bvss = make_multi_source_bfs(None, S, problem=prep.problem)
        f_dense = make_dense_multi_source_bfs(g, S, device=device)
        lv_b = f_bvss(internal).cpu().numpy()
        lv_d = f_dense(srcs).cpu().numpy()
        if not np.array_equal(lv_b[prep.perm], lv_d):
            raise KernelFaultError(
                f"bench_service/{gname}: BVSS and dense multi-source "
                f"levels differ")
        t_bvss = _median_time(f_bvss, internal)
        t_dense = _median_time(f_dense, srcs)
        ms = {
            "n_sources": S, "bvss_sec": t_bvss, "dense_sec": t_dense,
            "speedup_bvss_vs_dense": t_dense / max(t_bvss, 1e-12),
            "dense_adjacency_bytes": int(g.n * ((g.n + 31) // 32) * 4),
            "bvss_static_bytes": int(prep.bvss.memory_bytes()["bvss"]),
        }
        graphs_out[gname] = {"n": int(g.n), "m": int(g.m),
                             "ordering": prep.ordering, "multi_source": ms}
        if verbose:
            print(fmt_row(f"bench_service/{gname}/multi_source",
                          t_bvss * 1e6,
                          f"vs_dense={ms['speedup_bvss_vs_dense']:.2f}"))
    summary = {"geomean_bvss_vs_dense": geomean(
        [go["multi_source"]["speedup_bvss_vs_dense"]
         for go in graphs_out.values()])}
    if verbose:
        print(f"# geomean_bvss_vs_dense="
              f"{summary['geomean_bvss_vs_dense']:.2f}x")
    return {"device": str(device), "graphs": graphs_out, "summary": summary}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.scale, args.queries, device=args.device)


if __name__ == "__main__":
    main()
