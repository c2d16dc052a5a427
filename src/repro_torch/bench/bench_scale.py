"""The RMAT scale sweep: MTEPS and the footprint model of the BLEST
engine over growing RMAT graphs, the port of ``benchmarks/bench_scale.py``::

    PYTHONPATH=src python -m repro_torch.bench.bench_scale --scales 14 16 18

One graph family (RMAT, average degree 16, ``seed=1``, the paper's
kron-like scaling family).  Per scale the full ``prepare`` pipeline runs
(ordering + BVSS + policy + engine) and the sweep records

* MTEPS, million traversed edges per second: ``m / median BFS s / 1e6``
  over a fixed source sample, where a BFS is ``levels(src)`` ending in its
  device-to-host copy;
* ``BVSS.memory_bytes()``, the reference's Table-4 footprint model
  (static BVSS + dynamic working set + level array), not a reading of the
  card.

The SMALLEST scale is held against ``reference_bfs`` before any time is
taken (the larger scales share the same build path).  The BFSs run on the
card unless ``device="cpu"``.  The JSON has the reference's ``scales`` and
``summary`` keys under the port's envelope.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.bench.common import bench_envelope, fmt_row
from repro_torch.core.bfs import reference_bfs
from repro_torch.core.bvss import resolve_device
from repro_torch.core.policy import prepare
from repro_torch.errors import KernelFaultError
from repro_torch.graphs import generators as gen

FULL_SCALES = (10, 11, 12, 13, 14)
QUICK_SCALES = (10, 11)


def run(scales=None, quick: bool = False, n_sources: int = 3,
        json_path: str | None = None, verbose: bool = True,
        device=None) -> dict:
    device = resolve_device(device)
    if scales is None:
        scales = QUICK_SCALES if quick else FULL_SCALES
    scales = sorted(int(s) for s in scales)

    scales_out = {}
    for si, sc in enumerate(scales):
        g = gen.rmat(sc, 16, seed=1)
        prep = prepare(g, w=512, device=device)
        rng = np.random.default_rng(0)
        srcs = [int(s) for s in rng.integers(0, g.n, n_sources)]
        verified = True
        if si == 0:  # the smallest scale against the oracle
            for s in srcs:
                if not np.array_equal(prep.levels(s), reference_bfs(g, s)):
                    raise KernelFaultError(
                        f"bench_scale/rmat{sc}: levels from source {s} "
                        f"differ from the oracle")
        prep.levels(srcs[0])                      # warm: kernels, allocator
        ts = []
        for s in srcs:
            t0 = time.time()
            prep.levels(s)                        # ends in a host copy
            ts.append(time.time() - t0)
        t_med = float(np.median(ts))
        mem = prep.bvss.memory_bytes()
        scales_out[str(sc)] = {
            "n": int(g.n), "m": int(g.m),
            "ordering": prep.ordering, "engine": prep.engine_name,
            "n_sources": len(srcs),
            "median_bfs_sec": t_med,
            "mteps": g.m / max(t_med, 1e-12) / 1e6,
            "memory_bytes": mem,
            "peak_memory_bytes": int(mem["total"]),
            "verified": verified,
        }
        if verbose:
            so = scales_out[str(sc)]
            print(fmt_row(f"bench_scale/rmat{sc}", t_med * 1e6,
                          f"mteps={so['mteps']:.2f} "
                          f"mem={so['peak_memory_bytes'] / 1e6:.2f}MB"))

    summary = {
        "scales": scales,
        "max_mteps": max(so["mteps"] for so in scales_out.values()),
        "peak_memory_bytes_largest": scales_out[str(scales[-1])
                                                ]["peak_memory_bytes"],
        "all_verified": all(so["verified"] for so in scales_out.values()),
    }
    out = {
        **bench_envelope("rmat_scale", scales[-1], device),
        "family": "rmat_deg16",
        "note": ("MTEPS = m / median BFS seconds / 1e6 over a fixed source "
                 "sample per scale, each BFS ending in its device-to-host "
                 "copy; peak_memory_bytes is the BVSS.memory_bytes() "
                 "Table-4 model total (static BVSS + dynamic working set + "
                 "level array), not a reading of the device.  The smallest "
                 "scale is held against the oracle"),
        "scales": scales_out,
        "summary": summary,
    }
    if verbose:
        print(f"# max_mteps={summary['max_mteps']:.2f} "
              f"(verified={summary['all_verified']})")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=False)
        if verbose:
            print(f"# wrote {json_path}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help=f"scales {QUICK_SCALES} instead of {FULL_SCALES}")
    ap.add_argument("--scales", type=int, nargs="+", default=None)
    ap.add_argument("--sources", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(scales=args.scales, quick=args.quick, n_sources=args.sources,
        json_path=args.json, device=args.device)


if __name__ == "__main__":
    main()
