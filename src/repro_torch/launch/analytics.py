"""Analytics workload launcher — the DESIGN §2.6 suite end to end, on the
card (the port of ``repro/launch/analytics.py``)::

    PYTHONPATH=src python -m repro_torch.launch.analytics --graph rmat \
        --scale 10 --what components,extremes,betweenness
    PYTHONPATH=src python -m repro_torch.launch.analytics --graph rmat \
        --scale 10 --device cpu

Builds a :class:`repro_torch.GraphSession` (the ONE prepared pipeline) and
serves the requested analytics query kinds off its wave slot pool:
``components`` (flood-fill re-seeding), ``eccentricity`` (a sampled batch),
``extremes`` (iFUB diameter/radius), ``betweenness`` (sampled-source
Brandes), ``closeness`` (sampled closeness by wave level-channel
reduction), ``sssp`` (delta-stepping shortest paths over the min-plus
tiles with random dyadic edge weights) and ``pagerank`` (power
iteration over the float tiles, DESIGN §2.9).  ``--verify`` (the default)
checks every result but ``extremes`` against the independent SciPy and
NumPy oracles in ``repro_torch.kernels.ref``; each ``VERIFIED`` suffix
names the oracle that ran.

The session runs on the CUDA card unless ``--device cpu`` asks for the CPU
(the kernels' PyTorch twins).  ``--devices N > 1`` needs the sharded
analytics (ROADMAP.md queue 1 item 11d) and raises
:class:`~repro_torch.errors.ConfigError`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import GraphSession, PrepareOptions
from repro_torch.core.bvss import resolve_device
from repro_torch.errors import ConfigError, KernelFaultError
from repro_torch.launch.bfs import build_graph

WHAT = ("components", "eccentricity", "extremes", "betweenness",
        "closeness", "sssp", "pagerank")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "urand", "road", "clustered"])
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--what", default=",".join(WHAT),
                    help=f"comma-separated subset of {WHAT}")
    ap.add_argument("--sources", type=int, default=8,
                    help="sample size for eccentricity / betweenness")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="wave slot-pool width (stacked bit-SpMM columns)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="check every result against the SciPy/NumPy "
                         "oracles (--no-verify for timing runs)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run the session on the card (default) or on the "
                         "CPU through the kernels' PyTorch twins")
    ap.add_argument("--devices", type=int, default=1,
                    help="more than 1 is not ported yet: raises "
                         "ConfigError")
    args = ap.parse_args(argv)

    what = [w.strip() for w in args.what.split(",") if w.strip()]
    unknown = set(what) - set(WHAT)
    if unknown:
        ap.error(f"unknown --what entries {sorted(unknown)}")
    if args.devices != 1:
        raise ConfigError(
            "--devices is not ported to PyTorch yet: it comes with the "
            "sharded analytics (ROADMAP.md queue 1 item 11d)")
    resolve_device(args.device)     # no card and no --device cpu: raise now

    g = build_graph(args.graph, args.scale, args.seed)
    weights = None
    if "sssp" in what:
        # dyadic rationals: f32 path sums are exact, so --verify can
        # demand parity with the float64 Dijkstra oracle
        wrng = np.random.default_rng(args.seed + 1)
        weights = (wrng.integers(1, 128, g.m) / 32.0).astype(np.float32)
    sess = GraphSession(g, max_batch=args.max_batch,
                        options=PrepareOptions(w=512, seed=args.seed,
                                               weights=weights,
                                               device=args.device))
    print(f"[analytics] graph={args.graph} n={g.n} m={g.m} "
          f"ordering={sess.ordering} engine={sess.engine_name} "
          f"max_batch={sess.max_batch} device={args.device}")
    rng = np.random.default_rng(args.seed)

    if "components" in what:
        t0 = time.time()
        labels = sess.components()
        dt = time.time() - t0
        k = int(labels.max()) + 1 if len(labels) else 0
        sizes = np.bincount(labels)
        line = (f"[analytics] components: k={k} "
                f"largest={int(sizes.max())}/{g.n} in {dt * 1e3:.1f}ms")
        if args.verify:
            from repro_torch.kernels.ref import connected_components_ref
            if not (labels == connected_components_ref(g)).all():
                raise KernelFaultError(
                    "components diverge from the SciPy oracle")
            line += "; VERIFIED vs scipy"
        print(line)

    if "eccentricity" in what:
        srcs = rng.integers(0, g.n, args.sources)
        t0 = time.time()
        eccs = sess.eccentricity_batch(srcs)
        dt = time.time() - t0
        line = (f"[analytics] eccentricity: {len(srcs)} sources, "
                f"range [{eccs.min()}, {eccs.max()}] in {dt * 1e3:.1f}ms")
        if args.verify:
            from repro_torch.kernels.ref import eccentricity_ref
            ref = eccentricity_ref(g.symmetrized, srcs)
            if not (eccs == ref).all():
                raise KernelFaultError(
                    "eccentricity diverges from the oracle")
            line += "; VERIFIED vs scipy"
        print(line)

    if "extremes" in what:
        t0 = time.time()
        rep = sess.extremes()
        dt = time.time() - t0
        print(f"[analytics] extremes (iFUB): diameter="
              f"[{rep.diameter_lb}, {rep.diameter_ub}] "
              f"{'EXACT' if rep.exact else 'bounds'} "
              f"radius<={rep.radius_ub} center={rep.center} "
              f"periphery={rep.periphery} "
              f"({rep.n_ecc_evals} ecc evals / {g.n} vertices) "
              f"in {dt * 1e3:.1f}ms")

    if "betweenness" in what:
        t0 = time.time()
        srcs, bc = sess.betweenness_sample(args.sources, seed=args.seed)
        dt = time.time() - t0
        top = np.argsort(-bc)[:5]
        line = (f"[analytics] betweenness ({len(srcs)} pivots): top "
                f"{[(int(v), round(float(bc[v]), 1)) for v in top]} "
                f"in {dt * 1e3:.1f}ms")
        if args.verify:
            from repro_torch.kernels.ref import betweenness_ref
            ref = betweenness_ref(g, srcs)
            np.testing.assert_allclose(bc, ref, rtol=1e-4, atol=1e-4)
            line += "; VERIFIED vs Brandes oracle"
        print(line)

    if "closeness" in what:
        srcs = rng.integers(0, g.n, args.sources)
        t0 = time.time()
        cc = sess.closeness_batch(srcs)
        dt = time.time() - t0
        line = (f"[analytics] closeness: {len(srcs)} sources, "
                f"range [{cc.min():.4f}, {cc.max():.4f}] "
                f"in {dt * 1e3:.1f}ms")
        if args.verify:
            from repro_torch.kernels.ref import closeness_ref
            np.testing.assert_allclose(cc, closeness_ref(g, srcs),
                                       rtol=1e-9)
            line += "; VERIFIED vs scipy"
        print(line)

    if "sssp" in what:
        srcs = rng.integers(0, g.n, min(args.sources, g.n))
        t0 = time.time()
        dist = sess.sssp_batch(srcs)
        dt = time.time() - t0
        reached = np.isfinite(dist).sum(axis=1)
        line = (f"[analytics] sssp (delta-stepping): {len(srcs)} sources, "
                f"mean reached {reached.mean():.0f}/{g.n} "
                f"in {dt * 1e3:.1f}ms")
        if args.verify:
            from repro_torch.kernels.ref import sssp_ref
            ref = sssp_ref(g, srcs, weights)
            if not (np.array_equal(np.isinf(dist), np.isinf(ref))
                    and np.allclose(np.where(np.isinf(dist), 0.0, dist),
                                    np.where(np.isinf(ref), 0.0, ref),
                                    rtol=1e-6)):
                raise KernelFaultError(
                    "sssp diverges from the SciPy Dijkstra oracle")
            line += "; VERIFIED vs scipy"
        print(line)

    if "pagerank" in what:
        t0 = time.time()
        pr = sess.pagerank(tol=1e-10, max_iter=500)
        dt = time.time() - t0
        top = np.argsort(-pr)[:5]
        line = (f"[analytics] pagerank: sum={pr.sum():.6f} top "
                f"{[(int(v), round(float(pr[v]), 5)) for v in top]} "
                f"in {dt * 1e3:.1f}ms")
        if args.verify:
            from repro_torch.kernels.ref import pagerank_ref
            ref = pagerank_ref(g)
            rel = np.max(np.abs(pr - ref) / np.maximum(np.abs(ref), 1e-30))
            if rel > 1e-6:
                raise KernelFaultError(
                    f"pagerank diverges from the float64 power-iteration "
                    f"oracle (max rel err {rel:.2e})")
            line += "; VERIFIED vs float64 power iteration"
        print(line)


if __name__ == "__main__":
    main()
