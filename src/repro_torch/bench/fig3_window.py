"""Figure 3: effect of the JaccardWithWindows window size w on compression
and BFS time (GAP-web stand-in: the clustered community graph), the port
of ``benchmarks/fig3_window.py``::

    PYTHONPATH=src python -m repro_torch.bench.fig3_window

Per window w = 8, 16, ..., 4096 (up to n): the shingle-pre-ordered
``jaccard_windows`` permutation, its BVSS's compression, and the median
time of a single-source ``blest`` BFS on the permuted graph
(:func:`~repro_torch.bench.common.time_engine`, each BFS ending in its
device-to-host copy), every timed source's levels held against
``reference_bfs`` first.  The BFSs run on the card unless
``device="cpu"``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.bench.common import fmt_row, time_engine
from repro_torch.core.bfs import make_engine, reference_bfs
from repro_torch.core.bvss import build_bvss, resolve_device
from repro_torch.core.ordering import jaccard_windows, shingle_order
from repro_torch.errors import KernelFaultError
from repro_torch.graphs import generators as gen


def run(scale: int = 10, verbose: bool = True, device=None) -> list[str]:
    device = resolve_device(device)
    g = gen.clustered((1 << scale) // 64, 64, seed=4)
    pre = shingle_order(g)
    rows = []
    srcs = np.random.default_rng(0).integers(0, g.n, 3)
    for logw in range(3, 13):
        w = 1 << logw
        if w > g.n:
            break
        perm = jaccard_windows(g, w=w, pre_order=pre)
        gg = g.permute_fast(perm)
        b = build_bvss(gg)
        fn = make_engine(gg, "blest", bvss=b, device=device)
        for s in srcs:
            lv = fn(int(perm[s])).cpu().numpy()[perm]
            if not np.array_equal(lv, reference_bfs(g, int(s))):
                raise KernelFaultError(
                    f"fig3/w={w}: levels from source {s} differ from the "
                    f"oracle")
        sec = time_engine(fn, perm[srcs])
        row = fmt_row(f"fig3/w={w}", sec * 1e6,
                      f"compression={b.compression_ratio():.3f}")
        rows.append(row)
        if verbose:
            print(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.scale, device=args.device)


if __name__ == "__main__":
    main()
