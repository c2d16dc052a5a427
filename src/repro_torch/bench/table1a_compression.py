"""Table 1a: compression ratio and ordering time per heuristic on a
vsp_msc-like graph (star + random edges, shuffled labels), the port of
``benchmarks/table1a_compression.py``::

    PYTHONPATH=src python -m repro_torch.bench.table1a_compression

A host table: the orderings and the BVSS statistics are NumPy and launch
no kernel.  The time column is the ordering's host time; the derived
column equals the reference's row.  ``device`` names where the program
runs (the card unless ``device="cpu"``), as for every entry point.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bench.common import fmt_row
from repro_torch.core.bvss import build_bvss, resolve_device
from repro_torch.core.ordering import (jaccard_windows, natural_order,
                                       random_order, rcm, shingle_order)
from repro_torch.graphs import from_edges, src_of_edges
from repro_torch.graphs import generators as gen


def vsp_msc_like(n: int = 4096, seed: int = 0):
    """Random star graph: hub-heavy + uniform noise (the paper's Table-1a
    subject is vsp_msc, 'a random star graph')."""
    star = gen.star(n)
    rng = np.random.default_rng(seed)
    m_extra = n * 8
    src = np.concatenate([src_of_edges(star),
                          rng.integers(0, n, m_extra)])
    dst = np.concatenate([star.indices.astype(np.int64),
                          rng.integers(0, n, m_extra)])
    g = from_edges(n, src, dst)
    return g.permute_fast(rng.permutation(n))


def run(n: int = 4096, verbose: bool = True, device=None) -> list[str]:
    resolve_device(device)
    g = vsp_msc_like(n)
    rows = []
    orderings = [
        ("natural", lambda: natural_order(g)),
        ("random", lambda: random_order(g)),
        ("shingle(gorder-lite)", lambda: shingle_order(g)),
        ("rcm", lambda: rcm(g)),
        ("jaccard_windows", lambda: jaccard_windows(
            g, w=512, pre_order=shingle_order(g))),
    ]
    for name, fn in orderings:
        t0 = time.time()
        perm = fn()
        dt = time.time() - t0
        b = build_bvss(g.permute_fast(perm))
        row = fmt_row(f"table1a/{name}", dt * 1e6,
                      f"compression={b.compression_ratio():.3f}")
        rows.append(row)
        if verbose:
            print(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
