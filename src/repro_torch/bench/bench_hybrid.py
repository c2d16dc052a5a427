"""Hybrid BFS bench: the direction-optimizing hybrid with autotuned knobs
(DESIGN §2.8) against the pull-only 2-bucket engine, the port of
``benchmarks/bench_hybrid.py``::

    PYTHONPATH=src python -m repro_torch.bench.bench_hybrid --json h.json

Per graph of the reference's small-frontier-heavy suite (high-diameter
families whose traversals spend most levels far below the full queue
width):

* ``pull``   — ``direction="pull"``, the static 2-bucket ladder;
* ``hybrid`` — ``direction="auto"`` with the knobs
  ``core.autotune.tune()`` picked for this device.

Both engines go through the kernel entry points (``use_kernels=True``):
on the card the hand-written ``bvss_pull``, ``bvss_push_level`` and
``finalize_pack_sweep``, which ``tune`` also times (``bvss_pull`` and
``bvss_push``); on the CPU their twins.  The reference's lane is
"compiled-dispatch" (its jnp twins as one XLA computation, no Pallas
interpreter); the port has no counterpart of that lane: its level loop
runs on the host on either device.

Every graph is oracle-verified (levels AND a valid parents tree via
``parents_from_levels``) in ALL THREE direction modes before timing; a
failed verification zeroes the speedup rather than report it.  The JSON
has the reference's ``graphs`` and ``summary`` keys under the port's
envelope.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.bench.common import bench_envelope, fmt_row, geomean
from repro_torch.core.autotune import stats as autotune_stats
from repro_torch.core.autotune import tune
from repro_torch.core.bfs import (INF, BlestProblem, make_blest_bfs,
                                  queue_widths, reference_bfs)
from repro_torch.core.bvss import build_bvss, resolve_device
from repro_torch.core.policy import parents_from_levels
from repro_torch.graphs import Graph, generators as gen


def hybrid_suite(scale: int = 14) -> dict[str, Graph]:
    """Small-frontier-heavy families: high diameter, trickling frontiers,
    ``num_vss`` large enough that the static 2-bucket ladder's small rung
    (``num_vss / 8``) sits far above the real per-level live counts."""
    side = int((1 << scale) ** 0.5)
    return {
        "road": gen.grid2d(side, side, shuffle=True, seed=3),
        "web": gen.clustered((1 << scale) // 60, 60, p_in=0.4, seed=4),
        "rgg": gen.rgg2d(1 << scale, seed=5),
        # planted-partition graph whose frontier trace makes auto mode
        # alternate pull and push levels
        "flip": gen.clustered(40, 60, p_in=0.4, seed=1),
    }


#: graphs in the suite for oracle VERIFICATION only, excluded from the
#: geomean: flip is n = 2,400, its traversals too short to time above
#: dispatch noise; its job is a genuine pull/push multi-flip verified in
#: all three modes
TIMING_EXCLUDED = frozenset({"flip"})


def _best_sec(f, reps: int) -> float:
    """Min-of-``reps`` wall time: noise only ever adds time, so the minimum
    is the low-variance estimator of the ratio of two timed loops."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def _valid_parents(g: Graph, levels: np.ndarray, src: int) -> bool:
    parents = parents_from_levels(g, levels)
    if parents[src] != -1:
        return False
    reached = np.flatnonzero((levels != INF) & (np.arange(g.n) != src))
    return bool((parents[reached] >= 0).all()
                and (levels[parents[reached]] == levels[reached] - 1).all()
                and (parents[levels == INF] == -1).all())


def _verify(g: Graph, problem, cfg, src: int) -> dict[str, bool]:
    """Oracle parity (levels + parents) in all three direction modes."""
    want = reference_bfs(g, src)
    out = {}
    for direction in ("pull", "push", "auto"):
        fn = make_blest_bfs(problem, lazy=False, direction=direction,
                            **(cfg.engine_kwargs()
                               if direction == "auto" else {}))
        lv = fn(src).cpu().numpy()
        out[direction] = bool(np.array_equal(lv, want)
                              and _valid_parents(g, lv, src))
    return out


def run(scale: int = 14, n_sources: int = 2, reps: int = 5, device=None,
        json_path: str | None = None, verbose: bool = True) -> dict:
    """Time the pull and tuned hybrid engines per graph of
    :func:`hybrid_suite`; the speedup is zero where verification failed."""
    device = resolve_device(device)
    graphs_out = {}
    for gname, g in hybrid_suite(scale).items():
        rng = np.random.default_rng(0)
        cand = np.flatnonzero(g.out_degree > 0)
        srcs = [int(s) for s in rng.choice(
            cand, size=min(n_sources, len(cand)), replace=False)]
        b = build_bvss(g)
        problem = BlestProblem.build(b, device)
        cfg = tune(problem, use_kernels=True)
        verified = _verify(g, problem, cfg, srcs[0])

        pull_fn = make_blest_bfs(problem, lazy=False, buckets=2,
                                 direction="pull")
        hybrid_fn = make_blest_bfs(problem, lazy=False, direction="auto",
                                   **cfg.engine_kwargs())

        def sweep(fn):
            for s in srcs:
                fn(s).cpu()             # ends in a device-to-host copy

        sweep(pull_fn)      # warm
        sweep(hybrid_fn)
        pull_sec = _best_sec(lambda: sweep(pull_fn), reps) / len(srcs)
        hybrid_sec = _best_sec(lambda: sweep(hybrid_fn), reps) / len(srcs)
        ref = reference_bfs(g, srcs[0])
        n_levels = (int(ref[ref != INF].max()) if (ref != INF).any() else 0)
        speedup = (pull_sec / max(hybrid_sec, 1e-12)
                   if all(verified.values()) else 0.0)
        graphs_out[gname] = {
            "timed": gname not in TIMING_EXCLUDED,
            "n": int(g.n), "m": int(g.m), "num_vss": int(b.num_vss),
            "max_vss_per_set": int(problem.max_vss_per_set),
            "levels": n_levels,
            "base_widths": queue_widths(b.num_vss, 2),
            "tuned": {"widths": list(cfg.pull_widths),
                      "push_cap": cfg.push_cap, "alpha": cfg.alpha,
                      "source": cfg.source},
            "pull_sec": pull_sec, "hybrid_sec": hybrid_sec,
            "speedup_hybrid_vs_pull": speedup,
            "verified": verified,
        }
        if verbose:
            print(fmt_row(f"bench_hybrid/{gname}/pull", pull_sec * 1e6,
                          f"levels={n_levels}"))
            print(fmt_row(f"bench_hybrid/{gname}/hybrid", hybrid_sec * 1e6,
                          f"speedup={speedup:.2f};verified="
                          f"{all(verified.values())}"))
    summary = {
        "geomean_hybrid_vs_pull": geomean(
            [go["speedup_hybrid_vs_pull"] for go in graphs_out.values()
             if go["timed"]]),
        "all_verified": all(all(go["verified"].values())
                            for go in graphs_out.values()),
        "autotune": dict(autotune_stats),
    }
    out = {
        **bench_envelope("hybrid", scale, device),
        "lane": "kernels",
        "use_kernels": True,
        "n_sources": int(n_sources),
        "note": ("kernel entry points (the hand-written CUDA kernels on the "
                 "card, their twins on the CPU), host level loop; speedups "
                 "are zeroed unless the hybrid is oracle-exact in all three "
                 "direction modes, parents included; graphs with "
                 "timed=false are verification-only and excluded from the "
                 "geomean"),
        "graphs": graphs_out,
        "summary": summary,
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=False)
        if verbose:
            print(f"# wrote {json_path}")
    if verbose:
        print(f"# geomean_hybrid_vs_pull="
              f"{summary['geomean_hybrid_vs_pull']:.2f}x "
              f"all_verified={summary['all_verified']}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--sources", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.scale, args.sources, args.reps, device=args.device,
        json_path=args.json)


if __name__ == "__main__":
    main()
