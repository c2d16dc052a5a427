"""Table 2: the BFS engine matrix — BLEST variants (a/ab/ac/full) against
the baselines, the port of ``benchmarks/table2_bfs.py``::

    PYTHONPATH=src python -m repro_torch.bench.table2_bfs

Per (graph x variant of ``repro_torch.launch.bfs.ENGINE_VARIANTS``): ms per
BFS and its speedup against the BRS (BerryBees-like) frontier-oblivious
engine, the paper's "vs [27]" column, and for the BVSS engines the modeled
count of VSS pulls.  ``blest_full`` is the launcher's variant (the paper §5
policy picks eager or lazy), where the reference bench fixes it to lazy.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import numpy as np

from repro_torch.bench.common import (fmt_row, graph_suite,
                                      modeled_tc_pulls, time_engine)
from repro_torch.core.bfs import BlestProblem, make_engine, reference_bfs
from repro_torch.core.bvss import BVSS, build_bvss, resolve_device
from repro_torch.core.policy import (BVSS_ENGINES, PreparedBFS,
                                     choose_update_scheme, prepare)
from repro_torch.errors import KernelFaultError
from repro_torch.graphs import Graph
from repro_torch.launch.bfs import ENGINE_VARIANTS

#: the reference bench's row order: the CSR baselines, then BRS, then BLEST
VARIANTS = tuple(sorted(ENGINE_VARIANTS,
                        key=lambda k: (k.startswith("blest"), k == "brs")))


@dataclasses.dataclass(frozen=True)
class Variant:
    """One built variant: ``engine(internal src) -> levels tensor`` on the
    graph ``graph`` (``g`` itself or its ordering, named by ``ordering``)
    with ``perm`` mapping caller ids to internal ids, the engine's name
    ``core``, and the BVSS and device problem it runs on (None for the CSR
    engines)."""

    engine: Callable
    graph: Graph
    perm: np.ndarray
    ordering: str
    core: str
    bvss: BVSS | None
    problem: BlestProblem | None

    def levels(self, src: int) -> np.ndarray:
        """Levels in caller ids, as ``PreparedBFS.levels`` returns them."""
        return self.engine(int(self.perm[src])).cpu().numpy()[self.perm]


def variant_engines(g: Graph, *, device=None,
                    ordered: PreparedBFS | None = None) -> dict:
    """Build every Table-2 variant on ``g``: ``{name: Variant}`` in
    :data:`VARIANTS` order.  The unordered BVSS is built once and shared by
    ``brs``, ``blest_a`` and ``blest_ac``; the ordered variants share
    ``ordered`` (a BVSS-engine preparation of ``g`` with ordering, e.g. a
    session's), or one ``prepare(g)`` made here."""
    device = resolve_device(device)
    if ordered is None:
        ordered = prepare(g, device=device, engine="blest")
    nat_bvss = build_bvss(g)
    nat_problem = BlestProblem.build(nat_bvss, device)
    ident = np.arange(g.n, dtype=np.int64)
    out = {}
    for name in VARIANTS:
        v = ENGINE_VARIANTS[name]
        if v["order"]:
            core = v["engine"] or choose_update_scheme(ordered.bvss)
            fn = make_engine(ordered.graph, core, problem=ordered.problem,
                             device=device)
            out[name] = Variant(fn, ordered.graph, ordered.perm,
                                ordered.ordering, core, ordered.bvss,
                                ordered.problem)
        else:
            core = v["engine"]
            bvss, problem = ((nat_bvss, nat_problem) if core in BVSS_ENGINES
                             else (None, None))
            fn = make_engine(g, core, device=device, problem=problem)
            out[name] = Variant(fn, g, ident, "natural", core, bvss, problem)
    return out


def run(scale: int = 10, n_sources: int = 3, device=None,
        verbose: bool = True) -> list[str]:
    """The engine matrix over :func:`graph_suite`: one CSV row per (graph,
    variant), ms per BFS as microseconds, then the speedup against BRS.
    Every variant's levels are checked against the host oracle first."""
    device = resolve_device(device)
    rows = []
    for gname, g in graph_suite(scale).items():
        rng = np.random.default_rng(0)
        # sources with nonzero out-degree, so every BFS does work
        cand = np.flatnonzero(g.out_degree > 0)
        srcs = rng.choice(cand, size=min(n_sources, len(cand)),
                          replace=False)
        variants = variant_engines(g, device=device)
        sec, pulls = {}, {}
        for name, v in variants.items():
            want = reference_bfs(g, int(srcs[0]))
            if not np.array_equal(v.levels(int(srcs[0])), want):
                raise KernelFaultError(
                    f"table2/{gname}/{name}: levels differ from the oracle")
            internal = v.perm[srcs]
            sec[name] = time_engine(v.engine, internal)
            if v.bvss is not None:
                pulls[name] = int(np.mean([modeled_tc_pulls(
                    v.graph, v.bvss, int(s), frontier_aware=v.core != "brs")
                    for s in internal]))
        for name in VARIANTS:
            derived = f"speedup_vs_brs={sec['brs'] / sec[name]:.2f}x"
            if name in pulls:
                derived += (f";tc_pulls={pulls[name]};work_speedup_vs_brs="
                            f"{pulls['brs'] / max(pulls[name], 1):.2f}x")
            rows.append(fmt_row(f"table2/{gname}/{name}", sec[name] * 1e6,
                                derived))
            if verbose:
                print(rows[-1])
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--sources", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.scale, args.sources, device=args.device)


if __name__ == "__main__":
    main()
