"""The control of the comparison that decides ``correct``.

The control puts the plain reference in the program's place with one
guarantee of the configuration broken: each edge is followed only from its
lower vertex id to its higher one, so the graph is searched as directed.  On the
roots a run would draw from a seed, it reads the number that the run
compares (``wrong_vertices``, the most vertices of one answer whose level
differs from the reference), and the comparison has to call it wrong.

    python3 blest_bench/control.py --workload <name> --seeds 11,12,13

prints one JSON line a seed.  It runs on the host alone: the control
replaces the program, so no card is needed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seed: int) -> dict:
    """The control's reading on ``seed``'s roots: as many as a run checks,
    drawn as the run draws its window's calls."""
    import numpy as np
    from blest_bench import inputs, reference
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "blest_bench" / "mixes" /
                      f"{cell['traffic']}.json").read_text())
    per_call = int(mix.get("roots_per_batch", 1))
    size = int(config["reference_sample"])
    seed %= 2**64
    edges = inputs.make_graph(config, root / "blest_bench")
    roots = inputs.Roots(edges, seed, stream=0)
    picked = np.concatenate([roots.batch(per_call)
                             for _ in range(-(-size // per_call))])[:size]
    ref = reference.csr(edges.n, edges.a, edges.b)
    ctl = reference.csr(edges.n, edges.a, edges.b, control=True)
    wrong = max(reference.wrong_vertices(reference.bfs_levels(*ctl, int(r)),
                                         reference.bfs_levels(*ref, int(r)))
                for r in picked)
    return {"workload": workload, "seed": seed, "n": edges.n,
            "checked_answers": len(picked),
            "wrong_vertices_control": wrong, "limit": 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        row = readings(ROOT, args.workload, int(s))
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path = [str(ROOT), str(ROOT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != here]
    sys.exit(main())
