"""GraphSession serving bench: batched waves against sequential BFS, the
hardened manager's overhead, and BVSS against dense-adjacency
multi-source, the port of ``benchmarks/bench_service.py``::

    PYTHONPATH=src python -m repro_torch.bench.bench_service --json svc.json

Per graph of the suite:

* ``serve`` — N single-source level queries answered (a) sequentially
  through the single-source engine and (b) as one batched multi-source
  wave through :class:`~repro_torch.serve.GraphSession` (slot pool,
  lock-step levels, mid-flight refills).  Wave answers are held to
  ``reference_bfs`` and to the sequential answers before timing is
  reported.
* ``multi_source`` — the fixed-cohort multi-source engine on the BVSS
  bit-SpMM path (``core/multi_source.py``, the ``bvss_spmm_mark`` kernel)
  on the session's own prepared problem against the dense baseline below
  (``to_dense_bits`` adjacency + the ``bit_spmm`` kernel), both answers
  equal, with the adjacency footprint of each (the dense bitmap is
  n * ceil(n/32) words; the BVSS scales with slices).
* ``hardened`` — the same wave workload through the multi-tenant
  :class:`~repro_torch.serve.GraphSessionManager` (ingress validation,
  LRU touch, deadline clock hooks armed with a never-firing budget)
  against the bare session: the robustness layer's overhead (DESIGN §2.7
  requires it stay in the noise).

The engines run on the card unless ``device="cpu"``; every time is a host
clock around calls that end in host copies.  The JSON has the reference's
``graphs`` and ``summary`` keys under the port's envelope.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.bench.common import (bench_envelope, fmt_row, geomean,
                                      graph_suite, median_sec)
from repro_torch.core.bfs import INF, reference_bfs
from repro_torch.core.bvss import resolve_device
from repro_torch.core.multi_source import make_multi_source_bfs
from repro_torch.core.policy import PrepareOptions
from repro_torch.errors import KernelFaultError
from repro_torch.serve import GraphSessionManager, TimeoutResult
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
        json_path: str | None = None, verbose: bool = True) -> dict:
    """The ``serve``, ``multi_source`` and ``hardened`` sections over
    :func:`graph_suite`; raises :class:`KernelFaultError` where an answer
    differs from the oracle or from the other path."""
    device = resolve_device(device)
    graphs_out = {}
    for gname, g in graph_suite(scale).items():
        rng = np.random.default_rng(0)
        mgr = GraphSessionManager()
        sess = mgr.open_session(gname, g, max_batch=min(8, n_queries),
                                options=PrepareOptions(w=512, device=device))
        queries = [int(q) for q in rng.integers(0, g.n, n_queries)]

        # -- serve: batched wave vs N sequential single-source runs --------
        sess.levels(queries[0])                       # warm both paths
        sess.levels_batch(queries[: min(2, len(queries))])
        t0 = time.time()
        seq = [sess.levels(q) for q in queries]
        t_seq = time.time() - t0
        t0 = time.time()
        wave = sess.levels_batch(queries)
        t_wave = time.time() - t0
        verified = all(
            (lv == reference_bfs(g, q)).all() and (lv == lv_s).all()
            for q, lv, lv_s in zip(queries, wave, seq))
        if not verified:
            raise KernelFaultError(
                f"bench_service/{gname}: wave levels differ from "
                f"reference_bfs")
        serve = {
            "n_queries": n_queries, "max_batch": sess.max_batch,
            "sequential_sec": t_seq, "wave_sec": t_wave,
            "speedup": t_seq / max(t_wave, 1e-12), "verified": verified,
        }

        # -- hardened: manager-fronted wave vs the bare session ------------
        # the same engine underneath (the manager holds THIS session), so
        # the difference is the robustness layer: source validation, LRU
        # touch, and the per-level deadline clock hooks (armed with a
        # budget that never fires)
        t_plain = median_sec(lambda: sess.levels_batch(queries), reps=5)
        t_hard = median_sec(lambda: mgr.levels_batch(
            gname, queries, deadline_s=3600.0), reps=5)
        hard = mgr.levels_batch(gname, queries, deadline_s=3600.0)
        hardened_verified = (
            not any(isinstance(lv, TimeoutResult) for lv in hard)
            and all((lv == lv_s).all() for lv, lv_s in zip(hard, wave)))
        if not hardened_verified:
            raise KernelFaultError(
                f"bench_service/{gname}: hardened path diverges")
        hardened = {
            "n_queries": n_queries,
            "plain_sec": t_plain, "hardened_sec": t_hard,
            "plain_vs_hardened": t_plain / max(t_hard, 1e-12),
            "verified": hardened_verified,
        }

        # -- multi-source: BVSS bit-SpMM vs the dense baseline -------------
        # the BVSS engine rides the session's prepared (ordered) problem,
        # so bvss_static_bytes describes exactly the timed engine
        S = min(8, n_queries)
        srcs = rng.integers(0, g.n, S)
        internal = sess.perm[srcs]
        f_bvss = make_multi_source_bfs(None, S, problem=sess._problem)
        f_dense = make_dense_multi_source_bfs(g, S, device=device)
        lv_b = f_bvss(internal).cpu().numpy()
        lv_d = f_dense(srcs).cpu().numpy()
        if not np.array_equal(lv_b[sess.perm], lv_d):
            raise KernelFaultError(
                f"bench_service/{gname}: BVSS and dense multi-source "
                f"levels differ")
        t_bvss = _median_time(f_bvss, internal)
        t_dense = _median_time(f_dense, srcs)
        ms = {
            "n_sources": S, "bvss_sec": t_bvss, "dense_sec": t_dense,
            "speedup_bvss_vs_dense": t_dense / max(t_bvss, 1e-12),
            "dense_adjacency_bytes": int(g.n * ((g.n + 31) // 32) * 4),
            "bvss_static_bytes": int(sess.bvss.memory_bytes()["bvss"]),
        }

        social = sess.ordering == "jaccard_windows"
        graphs_out[gname] = {
            "n": int(g.n), "m": int(g.m),
            "social_like": social, "ordering": sess.ordering,
            "engine": sess.engine_name,
            "serve": serve, "multi_source": ms, "hardened": hardened,
        }
        if verbose:
            print(fmt_row(f"bench_service/{gname}/serve", t_wave * 1e6,
                          f"speedup={serve['speedup']:.2f};social={social}"))
            print(fmt_row(f"bench_service/{gname}/multi_source",
                          t_bvss * 1e6,
                          f"vs_dense={ms['speedup_bvss_vs_dense']:.2f}"))
            print(fmt_row(f"bench_service/{gname}/hardened", t_hard * 1e6,
                          f"plain_vs_hardened="
                          f"{hardened['plain_vs_hardened']:.3f}"))

    social_graphs = [go for go in graphs_out.values() if go["social_like"]]
    summary = {
        "geomean_wave_speedup": geomean(
            [go["serve"]["speedup"] for go in graphs_out.values()]),
        "geomean_wave_speedup_social": geomean(
            [go["serve"]["speedup"] for go in social_graphs]),
        "geomean_bvss_vs_dense": geomean(
            [go["multi_source"]["speedup_bvss_vs_dense"]
             for go in graphs_out.values()]),
        "geomean_hardened_vs_plain": geomean(
            [go["hardened"]["plain_vs_hardened"]
             for go in graphs_out.values()]),
        "all_verified": all(
            go["serve"]["verified"] and go["hardened"]["verified"]
            for go in graphs_out.values()),
    }
    out = {
        **bench_envelope("service", scale, device),
        "note": ("wave = GraphSession slot-pool serving (one batched BVSS "
                 "bit-SpMM pull per lock-step level, host refills between "
                 "levels); sequential = the same queries one at a time "
                 "through the single-source engine; hardened = the same "
                 "wave through GraphSessionManager with a never-firing "
                 "deadline; multi_source compares the BVSS SpMM engine "
                 "against the dense to_dense_bits + bit_spmm baseline"),
        "graphs": graphs_out,
        "summary": summary,
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=False)
        if verbose:
            print(f"# wrote {json_path}")
    if verbose:
        for k, v in summary.items():
            print(f"# {k}={v if isinstance(v, bool) else f'{v:.2f}x'}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.scale, args.queries, device=args.device, json_path=args.json)


if __name__ == "__main__":
    main()
