"""Connected components as batched wave flood-fill (DESIGN §2.6), the port
of ``repro/analytics/components.py``.

The algorithm is the serving loop wearing a different hat: seed up to S
wave columns with vertices no flood has touched yet, advance all floods in
lock-step through the one batched bit-SpMM pull per level, and every time
a column converges, harvest its reach set and *re-seed the freed slot with
the next untouched vertex* — the same mid-flight refill contract
(:func:`repro_torch.core.multi_source.drive_wave`) that serves level
queries, with the refill hook drawing from the shrinking untouched set.

Two floods seeded concurrently may land in the same component; overlapping
reach sets are merged with a union-find over flood ids at harvest time, so
the result is exact regardless of seeding order.  On a symmetric problem
(what ``GraphSession.components`` builds) every flood covers its whole
component; on a directed problem floods follow out-edges and overlap
merging recovers WEAK connectivity.

The FIRST flood runs through the single-source engine: on the common
giant-component topology it touches most of the graph before any wave
spins up.  Labels are normalised to 0..k-1 in order of each component's
smallest vertex id (``kernels.ref.normalize_labels``), matching the SciPy
oracle ``kernels.ref.connected_components_ref``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.analytics.common import host_levels
from repro_torch.core.bfs import BlestProblem
from repro_torch.core.multi_source import (INF, MSEngine, drive_wave,
                                           make_ms_engine)
from repro_torch.graphs import Graph
from repro_torch.kernels.ref import normalize_labels


def connected_components(g: Graph | None = None, *,
                         problem: BlestProblem | None = None,
                         engine: MSEngine | None = None,
                         first_flood: Callable | None = None,
                         max_batch: int = 8, use_kernel: bool = True,
                         symmetrize: bool = True,
                         device: "str | torch.device | None" = None
                         ) -> np.ndarray:
    """Component labels ``(n,)`` in the id space of ``g`` / ``problem``.

    Exactly one source of structure is used: an ``engine`` (reused wave
    slot pool, e.g. a session's), else a ``problem``, else ``g`` —
    symmetrised first by default so labels are classical (weak) components,
    and built on ``device`` (default: the card).  When passing
    ``problem``/``engine`` the caller owns symmetrisation.
    ``first_flood`` is an optional prebuilt single-source
    ``f(src) -> levels`` over the same problem (sessions pass their cached
    one; built on the fly otherwise).
    """
    if engine is None:
        if problem is None:
            if g is None:
                raise ValueError("need one of g / problem / engine")
            from repro_torch.core.bvss import build_bvss
            problem = BlestProblem.build(
                build_bvss(g.symmetrized if symmetrize else g), device)
        engine = make_ms_engine(problem, max_batch, use_kernel=use_kernel)
    problem = engine.problem
    n = problem.n
    if n == 0:
        return np.zeros(0, dtype=np.int64)

    touched = np.zeros(n, dtype=bool)   # seeded or inside a harvested flood
    vcomp = np.full(n, -1, dtype=np.int64)  # vertex -> flood id (pre-union)
    parent: list[int] = []              # union-find over flood ids
    slot_comp = [-1] * engine.n_slots
    # seeds are drawn in a fixed random order, NOT id order: the similarity
    # orderings co-locate each component's vertices in consecutive internal
    # ids, so an id-order cursor would drop a whole refill round of seeds
    # into one component
    seed_order = np.random.default_rng(0).permutation(n)
    scan = 0                            # monotone cursor into seed_order

    def find(c: int) -> int:
        while parent[c] != c:
            parent[c] = parent[parent[c]]
            c = parent[c]
        return c

    # phase 0: one single-source flood
    if first_flood is None:
        from repro_torch.core.bfs import make_blest_bfs
        first_flood = make_blest_bfs(problem, lazy=False,
                                     use_kernels=use_kernel)
    reach0 = host_levels(first_flood(0)) != INF
    parent.append(0)
    vcomp[reach0] = 0
    touched[reach0] = True
    if touched.all():  # connected graph: no wave needed
        return np.zeros(n, dtype=np.int64)

    # phase 1: wave flood-fill over whatever phase 0 left untouched at
    # full slot concurrency; the harvest-time union-find makes duplicate
    # floods of one component exact
    def next_source(slot: int) -> int | None:
        nonlocal scan
        while scan < n and touched[seed_order[scan]]:
            scan += 1
        if scan >= n:
            return None
        v = int(seed_order[scan])
        touched[v] = True
        c = len(parent)
        parent.append(c)
        slot_comp[slot] = c
        vcomp[v] = c
        return v

    def on_converged(slot: int, levels: np.ndarray) -> None:
        reach = np.flatnonzero(levels != INF)
        c = find(slot_comp[slot])
        for pc in np.unique(vcomp[reach]):
            if pc >= 0:  # overlap with an earlier flood: same component
                r = find(int(pc))
                parent[r] = c
        vcomp[reach] = c
        touched[reach] = True

    # every vertex is seeded at most once, every flood converges within
    # its component's diameter + 1 levels
    drive_wave(engine, next_source, on_converged,
               max_steps=(n + engine.n_slots) * (n + 2))
    roots = np.array([find(int(c)) for c in vcomp], dtype=np.int64)
    return normalize_labels(roots)
