"""Table 1b: update divergence before and after RCM on non-social graphs,
the port of ``benchmarks/table1b_divergence.py``::

    PYTHONPATH=src python -m repro_torch.bench.table1b_divergence

A host table: RCM and the BVSS statistics are NumPy and launch no kernel.
The time column is RCM's host time; the derived column equals the
reference's row.  ``device`` names where the program runs (the card unless
``device="cpu"``), as for every entry point.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.bench.common import fmt_row
from repro_torch.core.bvss import build_bvss, resolve_device
from repro_torch.core.ordering import rcm
from repro_torch.graphs import generators as gen


def run(scale: int = 11, verbose: bool = True, device=None) -> list[str]:
    resolve_device(device)
    side = int((1 << scale) ** 0.5)
    graphs = {
        "road(grid)": gen.grid2d(side, side, shuffle=True, seed=3),
        "rgg": gen.rgg2d(1 << scale, seed=5),
        "path": gen.path(1 << scale),
    }
    rows = []
    for name, g in graphs.items():
        u_before = build_bvss(g).update_divergence()
        t0 = time.time()
        perm = rcm(g)
        dt = time.time() - t0
        u_after = build_bvss(g.permute_fast(perm)).update_divergence()
        row = fmt_row(f"table1b/{name}", dt * 1e6,
                      f"udiv_before={u_before:.0f};udiv_after={u_after:.0f};"
                      f"reduction={u_before / max(u_after, 1e-9):.1f}x")
        rows.append(row)
        if verbose:
            print(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.scale, device=args.device)


if __name__ == "__main__":
    main()
