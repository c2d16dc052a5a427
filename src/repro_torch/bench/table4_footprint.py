"""Table 4: BVSS structural statistics and memory footprint per graph, the
port of ``benchmarks/table4_footprint.py``::

    PYTHONPATH=src python -m repro_torch.bench.table4_footprint

A host table over :func:`~repro_torch.bench.common.graph_suite`: the BVSS
statistics are NumPy and launch no kernel, and ``mem_mb`` is the
reference's footprint model (``BVSS.memory_bytes``), not a reading of the
card.  Every derived column equals the reference's row.  ``device`` names
where the program runs (the card unless ``device="cpu"``), as for every
entry point.
"""
from __future__ import annotations

import argparse

from repro_torch.bench.common import fmt_row, graph_suite
from repro_torch.core.bvss import build_bvss, resolve_device


def run(scale: int = 11, verbose: bool = True, device=None) -> list[str]:
    resolve_device(device)
    rows = []
    for name, g in graph_suite(scale).items():
        b = build_bvss(g)
        mem = b.memory_bytes()
        row = fmt_row(
            f"table4/{name}", 0.0,
            f"n_sets={b.n_sets};num_vss={b.num_vss};"
            f"slices={b.num_slices};padded_slices={b.num_vss * b.tau};"
            f"conn_bits={b.connectivity_bits()};"
            f"udiv={b.update_divergence():.0f};"
            f"compression={b.compression_ratio():.3f};"
            f"mem_mb={mem['total'] / 1e6:.2f}")
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
