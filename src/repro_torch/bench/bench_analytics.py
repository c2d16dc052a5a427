"""Analytics bench: the batched-wave verbs against sequential single-source
baselines and the oracles, the port of ``benchmarks/bench_analytics.py``::

    PYTHONPATH=src python -m repro_torch.bench.bench_analytics --scale 12

Per graph of the suite (``graph_suite`` plus ``frag``, disconnected
communities):

* ``components`` — the wave flood-fill with slot re-seeding
  (``GraphSession.components``) against a sequential baseline running one
  single-source BFS per seed over the SAME symmetrised tiles
  (``sess._sym_sss()`` on ``sess._sym_problem()``), both against the SciPy
  oracle;
* ``eccentricity`` — one fixed-cohort wave against N sequential runs;
* ``betweenness`` — the σ-channel wave forward and reverse tile sweep
  against the NumPy Brandes oracle (max error relative to the largest
  score below 1e-4);
* ``closeness`` — wave cohorts against N sequential single-source runs
  reduced the same way, both against SciPy;
* ``sssp`` — batched delta-stepping over the min-plus tiles against
  SciPy's Dijkstra (its wall time is the baseline); dyadic weights make
  the f32 distances equal to the float64 oracle's;
* ``pagerank`` — the power iteration over the float tiles against the
  float64 power-iteration oracle ``pagerank_ref`` (its wall time is the
  baseline; the key keeps the reference's name ``networkx_sec``), within
  5e-6 relative at suite scale, as the reference bench allows.

Every time is a host-clock median of three calls after a warm call; each
call ends in host copies.  The verbs run on the card unless
``device="cpu"``.  The JSON has the reference's ``graphs`` and ``summary``
keys under the port's envelope.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import GraphSession, PrepareOptions
from repro_torch.analytics.closeness import closeness_from_levels
from repro_torch.bench.common import (bench_envelope, fmt_row, geomean,
                                      graph_suite, median_sec)
from repro_torch.core.bfs import INF
from repro_torch.core.bvss import resolve_device
from repro_torch.errors import KernelFaultError
from repro_torch.graphs import generators as gen
from repro_torch.kernels.ref import (betweenness_ref, closeness_ref,
                                     connected_components_ref,
                                     eccentricity_ref, normalize_labels,
                                     pagerank_ref, sssp_ref)


def _sequential_components(n: int, levels_fn, perm) -> np.ndarray:
    """Baseline: per-seed single-source BFS flood-fill over the symmetrised
    problem (no wave batching), labels in caller ids."""
    vcomp = np.full(n, -1, dtype=np.int64)
    scan = 0
    c = 0
    while True:
        while scan < n and vcomp[scan] >= 0:
            scan += 1
        if scan >= n:
            break
        lv = levels_fn(scan)
        vcomp[lv != INF] = c
        c += 1
    return normalize_labels(vcomp[perm])


def run(scale: int = 9, n_queries: int = 8, n_pivots: int = 4,
        json_path: str | None = None, verbose: bool = True,
        device=None) -> dict:
    device = resolve_device(device)
    suite = graph_suite(scale)
    # the component-rich regime the flood-fill is FOR: disconnected
    # communities (p_out=0), the workload class of components queries
    suite["frag"] = gen.clustered((1 << scale) // 32, 32, p_out=0.0, seed=6)
    graphs_out = {}
    for gname, g in suite.items():
        rng = np.random.default_rng(0)
        # dyadic rationals: f32 path sums are exact, so the wave distances
        # must MATCH the float64 Dijkstra oracle (not just approximate it)
        wts = (rng.integers(1, 128, g.m) / 32.0).astype(np.float32)
        sess = GraphSession(g, max_batch=min(8, n_queries),
                            options=PrepareOptions(w=512, weights=wts,
                                                   device=device))
        seq_bfs = sess._sym_sss()   # the baseline IS the phase-0 engine:
                                    # same tiles, no wave batching

        def seq_levels(src_internal: int) -> np.ndarray:
            return seq_bfs(int(src_internal)).cpu().numpy()

        def seq_components() -> np.ndarray:
            return _sequential_components(sess.n, seq_levels, sess.perm)

        # -- components: wave flood-fill vs sequential per-seed BFS --------
        sess.components()                                  # warm wave path
        seq_levels(0)                                      # warm baseline
        labels = sess.components()
        labels_seq = seq_components()
        t_wave = median_sec(sess.components)
        t_seq = median_sec(seq_components)
        ref = connected_components_ref(g)
        cverified = bool((labels == ref).all() and (labels_seq == ref).all())
        if not cverified:
            raise KernelFaultError(
                f"{gname}: component labels diverge from scipy")
        comp = {
            "n_components": int(labels.max()) + 1,
            "sequential_sec": t_seq, "wave_sec": t_wave,
            "speedup": t_seq / max(t_wave, 1e-12), "verified": cverified,
        }

        # -- eccentricity: one batched wave vs N sequential runs -----------
        srcs = rng.integers(0, g.n, n_queries)
        internal = sess.perm[srcs]
        sess.eccentricity_batch(srcs)                # warm at the timed width
        eccs = sess.eccentricity_batch(srcs)

        def seq_ecc() -> np.ndarray:
            return np.array([
                int(np.where((lv := seq_levels(int(s))) != INF,
                             lv, 0).max()) for s in internal])

        eccs_seq = seq_ecc()
        t_wave_e = median_sec(lambda: sess.eccentricity_batch(srcs))
        t_seq_e = median_sec(seq_ecc)
        ref_e = eccentricity_ref(g.symmetrized, srcs)
        everified = bool((eccs == ref_e).all() and (eccs_seq == ref_e).all())
        if not everified:
            raise KernelFaultError(
                f"{gname}: eccentricity diverges from scipy")
        ecc = {
            "n_queries": int(n_queries),
            "sequential_sec": t_seq_e, "wave_sec": t_wave_e,
            "speedup": t_seq_e / max(t_wave_e, 1e-12), "verified": everified,
        }

        # -- betweenness: σ-channel wave + reverse tile sweep ---------------
        pivots = rng.choice(g.n, size=min(n_pivots, g.n), replace=False)
        sess.betweenness_batch(pivots)               # warm at the timed width
        bc = sess.betweenness_batch(pivots)
        t_bc = median_sec(lambda: sess.betweenness_batch(pivots))
        ref_bc = betweenness_ref(g, pivots)
        scale_ref = max(float(np.abs(ref_bc).max()), 1.0)
        max_rel_err = float(np.abs(bc - ref_bc).max()) / scale_ref
        bverified = bool(max_rel_err < 1e-4)
        if not bverified:
            raise KernelFaultError(f"{gname}: betweenness err {max_rel_err}")
        bet = {
            "n_pivots": int(len(pivots)), "wave_sec": t_bc,
            "max_rel_err": max_rel_err, "verified": bverified,
        }

        # -- closeness: wave cohorts vs N sequential runs -------------------
        srcs_c = rng.integers(0, g.n, n_queries)
        sess.closeness_batch(srcs_c)                 # warm at the timed width
        cc = sess.closeness_batch(srcs_c)

        def seq_close() -> np.ndarray:
            return np.concatenate([
                closeness_from_levels(sess.levels(int(s))[:, None])
                for s in srcs_c])

        cc_seq = seq_close()
        t_wave_c = median_sec(lambda: sess.closeness_batch(srcs_c))
        t_seq_c = median_sec(seq_close)
        ref_c = closeness_ref(g, srcs_c)
        closeverified = bool(
            np.allclose(cc, ref_c, rtol=1e-9)
            and np.allclose(cc_seq, ref_c, rtol=1e-9))
        if not closeverified:
            raise KernelFaultError(
                f"{gname}: closeness diverges from scipy")
        close = {
            "n_queries": int(n_queries),
            "sequential_sec": t_seq_c, "wave_sec": t_wave_c,
            "speedup": t_seq_c / max(t_wave_c, 1e-12),
            "verified": closeverified,
        }

        # -- sssp: batched delta-stepping waves vs the SciPy oracle ---------
        srcs_s = rng.integers(0, g.n, n_queries)
        sess.sssp_batch(srcs_s)                # warm at the timed width
        dist = sess.sssp_batch(srcs_s)
        t_wave_s = median_sec(lambda: sess.sssp_batch(srcs_s))
        t_scipy = median_sec(lambda: sssp_ref(g, srcs_s, wts))
        ref_s = sssp_ref(g, srcs_s, wts)
        sverified = bool(
            np.array_equal(np.isinf(dist), np.isinf(ref_s))
            and np.allclose(np.where(np.isinf(dist), 0.0, dist),
                            np.where(np.isinf(ref_s), 0.0, ref_s),
                            rtol=1e-6))
        if not sverified:
            raise KernelFaultError(
                f"{gname}: sssp diverges from the Dijkstra oracle")
        sssp = {
            "n_sources": int(n_queries),
            "scipy_sec": t_scipy, "wave_sec": t_wave_s,
            "speedup": t_scipy / max(t_wave_s, 1e-12), "verified": sverified,
        }

        # -- pagerank: power iteration over the tiles vs the oracle --------
        sess.pagerank(tol=1e-10, max_iter=500)             # warm
        pr = sess.pagerank(tol=1e-10, max_iter=500)
        t_pr = median_sec(lambda: sess.pagerank(tol=1e-10, max_iter=500))
        t_ref = median_sec(lambda: pagerank_ref(g))
        ref_pr = pagerank_ref(g)
        pr_rel = float(np.max(np.abs(pr - ref_pr)
                              / np.maximum(np.abs(ref_pr), 1e-30)))
        # 5e-6 here, not the CLI's 1e-6, as in the reference bench: the
        # error floor of the iterate grows with n, and the bench runs at
        # suite scale
        pverified = bool(pr_rel <= 5e-6)
        if not pverified:
            raise KernelFaultError(f"{gname}: pagerank err {pr_rel}")
        pagerank = {
            "networkx_sec": t_ref, "wave_sec": t_pr,
            "speedup": t_ref / max(t_pr, 1e-12),
            "max_rel_err": pr_rel, "verified": pverified,
        }

        graphs_out[gname] = {
            "n": int(g.n), "m": int(g.m), "ordering": sess.ordering,
            "components": comp, "eccentricity": ecc, "betweenness": bet,
            "closeness": close, "sssp": sssp, "pagerank": pagerank,
        }
        if verbose:
            print(fmt_row(f"bench_analytics/{gname}/components",
                          t_wave * 1e6, f"speedup={comp['speedup']:.2f}"))
            print(fmt_row(f"bench_analytics/{gname}/eccentricity",
                          t_wave_e * 1e6, f"speedup={ecc['speedup']:.2f}"))
            print(fmt_row(f"bench_analytics/{gname}/betweenness",
                          t_bc * 1e6, f"err={max_rel_err:.1e}"))
            print(fmt_row(f"bench_analytics/{gname}/closeness",
                          t_wave_c * 1e6, f"speedup={close['speedup']:.2f}"))
            print(fmt_row(f"bench_analytics/{gname}/sssp",
                          t_wave_s * 1e6, f"speedup={sssp['speedup']:.2f}"))
            print(fmt_row(f"bench_analytics/{gname}/pagerank",
                          t_pr * 1e6,
                          f"speedup={pagerank['speedup']:.2f}"))

    summary = {
        "geomean_components_speedup": geomean(
            [go["components"]["speedup"] for go in graphs_out.values()]),
        "geomean_ecc_speedup": geomean(
            [go["eccentricity"]["speedup"] for go in graphs_out.values()]),
        "geomean_closeness_speedup": geomean(
            [go["closeness"]["speedup"] for go in graphs_out.values()]),
        "geomean_sssp_speedup": geomean(
            [go["sssp"]["speedup"] for go in graphs_out.values()]),
        "geomean_pagerank_speedup": geomean(
            [go["pagerank"]["speedup"] for go in graphs_out.values()]),
        "all_verified": all(
            go["components"]["verified"] and go["eccentricity"]["verified"]
            and go["betweenness"]["verified"]
            and go["closeness"]["verified"] and go["sssp"]["verified"]
            and go["pagerank"]["verified"]
            for go in graphs_out.values()),
    }
    out = {
        **bench_envelope("analytics", scale, device),
        "note": ("components/eccentricity = batched wave (stacked bit-SpMM "
                 "columns, slot re-seeding) vs sequential single-source BFS "
                 "over the same symmetrised BVSS; betweenness = Brandes "
                 "forward σ wave channel + reverse sweep over the recorded "
                 "per-level tile queues, against the NumPy Brandes oracle; "
                 "closeness = wave-cohort level-channel reduction vs "
                 "sequential single-source runs, against SciPy; sssp = "
                 "batched delta-stepping over the min-plus tiles vs the "
                 "SciPy Dijkstra oracle (dyadic weights, exact match); "
                 "pagerank = power iteration over the float tiles vs the "
                 "float64 power-iteration oracle (networkx_sec times that "
                 "oracle; the key keeps the reference's name)"),
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
    ap.add_argument("--pivots", type=int, default=4)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(scale=args.scale, n_queries=args.queries, n_pivots=args.pivots,
        json_path=args.json, device=args.device)


if __name__ == "__main__":
    main()
