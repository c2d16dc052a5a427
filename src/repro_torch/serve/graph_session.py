"""GraphSession: batched BFS query serving over one prepared graph
(DESIGN §2.5), the port of ``repro/serve/graph_session.py``.

A session owns ALL prepared state for one graph — ordering decision,
permutation + inverse, BVSS, the single-source engine, and the batched
multi-source wave machinery — via the single static pipeline in
:func:`repro_torch.core.policy.prepare`.

Concurrent single-source level queries are served in *waves*: a fixed
pool of ``max_batch`` source columns advances in lock-step levels through
one batched BVSS bit-SpMM per level (CUDA ``bvss_spmm_mark``, which
stores the level's hit marks itself); a column whose
frontier empties is harvested and its slot refilled from the request
queue mid-flight, so queries that arrive together share every adjacency
read regardless of how their depths differ.  Singleton traffic takes the
single-source engine.

Id-space contract: callers speak ORIGINAL vertex ids everywhere — sources
in, level arrays / centrality scores / component labels out.  The internal
reordering is invisible.

Beyond level queries, a session serves every verb of
:attr:`GraphSession.VERBS` on the same slot-pool width: the pure wave
clients ``components()``, ``eccentricity_batch()`` / ``extremes()`` and
``closeness_batch()`` (DESIGN §2.6; the undirected ones on a lazily built
symmetrised twin of the prepared problem), and the float-channel verbs
``betweenness_batch()`` (CUDA ``bvss_spmm_mark``, ``bvss_spmm_w`` and
``bvss_spmm_t``), ``sssp()`` / ``sssp_batch()`` (``bvss_spmm_minplus``
against the edge-weight plane) and ``pagerank()`` (``bvss_spmm_w``).
``weights=`` (one strictly positive float per CSR edge) arms SSSP; an
unweighted session lazily defaults to unit weights, so ``sssp`` gives hop
counts.

``fault_plan=`` (a :class:`~repro_torch.serve.faults.FaultPlan`) bakes
fault wrappers into the session's engines at the documented seams (DESIGN
§2.7): the single-source push seam, the wave pools' bit-SpMM and the
Brandes σ channel.  ``autotune=True`` measures the hybrid's ladder and
push cap for the device (``core/autotune.py``).

``update_edges`` applies a streaming edge-update batch (DESIGN §2.10,
``core/bvss_delta.py``) and swaps the session to the next epoch; waves in
flight finish on the epoch they started with.

A session is mesh-native (DESIGN §2.4): with ``mesh=`` (a
:class:`torch.distributed.device_mesh.DeviceMesh`) every rank of the mesh
builds the same session on the same graph and makes the same calls
(SPMD); each holds its own shard, and every verb answers the whole graph
on every rank.  The wave pools, the symmetrised twin, the weight plane
and the verbs' engines are all sharded; the single-source engine is
``prepare``'s sharded one.  On a 2-D mesh the weighted verbs (``sssp``,
``pagerank``) raise :class:`~repro_torch.errors.ConfigError`, as the
reference's do.  ``update_edges`` on a mesh patches each rank's own
shard (1-D) or rebuilds the sharded problem (2-D, or a set whose VSS
count changes in any shard); every rank makes the same call and takes
the same path, and the sharded wave pool, symmetrised twin and weight
plane rebuild lazily against the new epoch.
"""
from __future__ import annotations

import itertools
import time
import warnings
from collections import deque
from typing import Sequence

import numpy as np

from repro_torch.analytics import (ExtremesReport, betweenness_centrality,
                                   closeness_centrality,
                                   connected_components, eccentricities,
                                   ifub_extremes, make_betweenness,
                                   make_pagerank, make_sssp, out_degrees,
                                   pagerank_scores, sssp_distances)
from repro_torch.core.bfs import BlestProblem, make_blest_bfs
from repro_torch.core.bvss import (build_sharded_bvss,
                                   build_sharded_weight_plane,
                                   build_weight_plane, weight_plane_to_device)
from repro_torch.core.bvss_delta import apply_edge_updates
from repro_torch.core.multi_source import (drive_wave, make_ms_engine,
                                           make_multi_source_bfs)
from repro_torch.core.policy import (PreparedBFS, PrepareOptions,
                                     build_problem, prepare)
from repro_torch.distributed.collectives import axis_size
from repro_torch.errors import ConfigError, check_source, check_sources
from repro_torch.graphs import Graph
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ref import normalize_labels
from repro_torch.serve.faults import NO_FAULTS, FaultPlan
from repro_torch.tracing import span


def _alias_warning(old: str, new: str) -> None:
    warnings.warn(
        f"GraphSession.{old}() is a deprecated alias; call "
        f"GraphSession.{new}() (same semantics, the 0.5 verb convention: "
        f"singular verbs take src, batched verbs take sources, sampling "
        f"verbs take k with keyword-only seed)",
        DeprecationWarning, stacklevel=3)


class GraphSession:
    """Prepared, query-serving state for one graph.

    Parameters mirror :func:`repro_torch.core.policy.prepare`;
    ``max_batch`` is the wave slot-pool width (the S of the stacked
    bit-SpMM frontier); ``mesh`` row-shards the session over a
    ``DeviceMesh`` (every rank of it builds the session); ``weights`` (one
    strictly positive float per CSR edge of ``g``) arms the weighted
    verbs.  Like ``prepare``, the session runs on the card unless
    ``options=PrepareOptions(device="cpu")`` asks for the CPU (a gloo
    mesh is given there as ``options.mesh``).
    """

    #: every query verb a session serves (the reference's tuple)
    VERBS = ("levels", "components", "eccentricity", "betweenness",
             "closeness", "sssp", "pagerank")

    def __init__(self, g: Graph, *, max_batch: int = 8,
                 options: PrepareOptions | None = None, sigma: int = 8,
                 w: int = 512, seed: int = 0,
                 lazy_threshold: float | None = None, order: bool = True,
                 engine: str | None = None, use_kernel: bool = True,
                 direction: str = "auto", autotune: bool = False,
                 max_steps: int | None = None, mesh=None,
                 mesh_axis: str = "data", weights=None,
                 fault_plan: FaultPlan | None = None):
        t0 = time.time()
        if options is None:
            options = PrepareOptions(
                sigma=sigma, w=w, seed=seed, lazy_threshold=lazy_threshold,
                order=order, engine=engine, use_kernels=use_kernel,
                direction=direction, autotune=autotune, mesh=mesh,
                mesh_axis=mesh_axis, weights=weights)
        elif weights is not None or mesh is not None or \
                (sigma, w, seed, lazy_threshold, order, engine, use_kernel,
                 direction, autotune, mesh_axis) != \
                (8, 512, 0, None, True, None, True, "auto", False, "data"):
            raise ConfigError(
                "GraphSession takes EITHER options=PrepareOptions(...) or "
                "the per-knob keywords, not both")
        # fault seams (DESIGN §2.7): a FaultPlan's wrappers go into every
        # engine this session builds, the single-source engine's push seam
        # included, so they must exist BEFORE prepare(); the default plan
        # injects nothing
        self.fault_plan = fault_plan if fault_plan is not None else NO_FAULTS
        self._seams = self.fault_plan.engine_overrides(
            use_kernel=options.use_kernels)
        if self._seams.get("push_impl") is not None:
            options = options.replace(push_impl=self._seams["push_impl"])
        self.options = options
        self.max_batch = int(max_batch)
        self._use_kernel = options.use_kernels
        self._direction = options.direction
        self._mesh_axis = options.mesh_axis
        self.max_steps = max_steps
        self._batch_ids = itertools.count(1)   # request ids of wave.batch
        with span("session.prepare"):
            self.prepared: PreparedBFS = prepare(g, options=options)
            with span("session.bind"):
                self._bind_prepared()
        self.preprocess_s = time.time() - t0

    def _bind_prepared(self) -> None:
        """(Re)build everything derived from ``self.prepared`` — called at
        construction and after every :meth:`update_edges` epoch swap."""
        # a CSR/dense engine override prepares no device BVSS, but the wave
        # pool needs one: build it session-local, on the prepared device
        self._problem: BlestProblem = self.prepared.problem \
            if self.prepared.problem is not None else \
            BlestProblem.build(self.prepared.bvss, self.prepared.device)
        self._ms = make_ms_engine(self._problem, self.max_batch,
                                  use_kernel=self._use_kernel,
                                  direction=self._direction, **self._seams)
        # analytics problems/engines (the symmetrised problem included),
        # built on first use and cached
        self._analytics_cache: dict = {}

    def update_edges(self, inserts=(), deletes=(), *, insert_weights=None,
                     expected_epoch: int | None = None,
                     staleness_budget: int | None = None):
        """Apply a streaming edge-update batch (caller ids) and swap the
        session to the next epoch (DESIGN §2.10); returns the
        :class:`~repro_torch.core.bvss_delta.UpdateReport`, or ``None`` for
        an effective no-op.

        The swap is atomic from the session's point of view: a wave in
        flight keeps the engine and permutation it started with, whose
        device tensors the update never writes, and finishes on the old
        epoch; queries issued after this returns see the new one.  The
        derived engines — the wave pool, the cached analytics problems and
        engines — are rebuilt against the new epoch."""
        after = apply_edge_updates(
            self.prepared, inserts, deletes, insert_weights=insert_weights,
            expected_epoch=expected_epoch,
            staleness_budget=staleness_budget)
        if after is self.prepared:      # effective no-op: same epoch
            return None
        self.prepared = after
        self._bind_prepared()
        return after.last_update

    # ------------------------------------------------------------------
    # prepared-state passthrough
    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.prepared.graph.n

    @property
    def perm(self) -> np.ndarray:
        return self.prepared.perm

    @property
    def inv(self) -> np.ndarray:
        return self.prepared.inv

    @property
    def bvss(self):
        return self.prepared.bvss

    @property
    def ordering(self) -> str:
        return self.prepared.ordering

    @property
    def engine_name(self) -> str:
        return self.prepared.engine_name

    @property
    def mesh(self):
        """The ``DeviceMesh`` the session is row-sharded over (None on one
        device)."""
        return self.prepared.mesh

    @property
    def epoch(self) -> int:
        """Edge-update epoch of the prepared state (DESIGN §2.10)."""
        return self.prepared.epoch

    def counters(self) -> dict:
        """A snapshot of the program's counters: ``"wave"``, the wave
        engine's (``host_syncs``, ``pull_levels``, ``push_levels``, and
        over the pull levels the launched queue width ``pull_width`` and
        the live VSSs in it ``pull_live``; an edge update's new epoch
        starts them at 0), and ``"launches"``, every hand kernel's
        launches in this process (:func:`repro_torch.kernels.launch_counts`).
        """
        return {"wave": dict(self._ms.stats), "launches": launch_counts()}

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def levels(self, src: int) -> np.ndarray:
        """Single-source BFS levels in caller ids."""
        return self.prepared.levels(src)

    def levels_batch(self, sources: Sequence[int], *,
                     should_harvest=None, on_harvested=None
                     ) -> list[np.ndarray | None]:
        """Serve concurrent level queries as batched multi-source waves.

        Returns one level array per query, aligned with ``sources``, in
        the caller's vertex ids.  More queries than ``max_batch`` are
        queued and refilled into freed slots mid-flight.

        ``should_harvest(i)`` / ``on_harvested(i, partial_levels)`` are
        the per-request cancellation hooks (DESIGN §2.7), in REQUEST
        INDEX space (``i`` indexes ``sources``): after every lock-step
        level each still-running request is offered to ``should_harvest``;
        answering True cancels it mid-flight — ``on_harvested`` receives
        the partial caller-id levels (unreached vertices ``INF``), the
        returned list carries ``None`` at that index, and the freed slot
        is refilled from the queue.  Singleton traffic normally takes the
        single-source engine, which cannot be preempted, so a singleton
        WITH hooks rides the wave pool instead.
        """
        srcs = check_sources(sources, self.n)
        if not srcs:
            return []
        if len(srcs) == 1 and should_harvest is None:
            # singleton traffic: no batching win available
            return [self.levels(srcs[0])]
        perm = self.perm
        queue = deque(enumerate(srcs))
        owner: list[int | None] = [None] * self.max_batch
        results: dict[int, np.ndarray | None] = {}

        def next_source(slot: int) -> int | None:
            if not queue:
                return None
            rid, src = queue.popleft()
            owner[slot] = rid
            return int(perm[src])

        def on_converged(slot: int, lv: np.ndarray) -> None:
            results[owner[slot]] = lv[perm]
            owner[slot] = None

        _should = _harvested = None
        if should_harvest is not None:
            def _should(slot: int) -> bool:
                rid = owner[slot]
                return rid is not None and bool(should_harvest(rid))

            def _harvested(slot: int, lv: np.ndarray) -> None:
                rid = owner[slot]
                if on_harvested is not None:
                    on_harvested(rid, lv[perm])
                results[rid] = None
                owner[slot] = None

        limit = self.max_steps if self.max_steps is not None else \
            (len(srcs) + self.max_batch) * (self.n + 1)
        with span("wave.batch", request=next(self._batch_ids)):
            drive_wave(self._ms, next_source, on_converged, max_steps=limit,
                       should_harvest=_should, on_harvested=_harvested)
        return [results[i] for i in range(len(srcs))]

    # ------------------------------------------------------------------
    # centrality
    # ------------------------------------------------------------------
    def closeness_batch(self, sources: Sequence[int] | None = None, *,
                        wf_improved: bool = False) -> np.ndarray:
        """Closeness centrality (caller ids throughout): one score per
        given source, or — with ``sources=None`` — the EXACT variant, one
        score per vertex in caller-id order.  Fixed cohorts, so this
        skips the wave refill loop and runs the cached fixed-cohort
        multi-source engine (DESIGN §2.5/§2.6); scores are invariant under
        the internal reordering."""
        if sources is None:
            internal = self.perm.astype(np.int64)   # caller v -> perm[v]
        else:
            srcs = check_sources(sources, self.n)
            if not srcs:
                return np.zeros(0, dtype=np.float64)
            internal = self.perm[np.asarray(srcs)].astype(np.int64)
        width = min(self.max_batch, len(internal))
        return closeness_centrality(None, internal, batch=width,
                                    wf_improved=wf_improved,
                                    levels_fn=self._dir_wave(width))

    def closeness(self, sources: Sequence[int] | None = None, *,
                  wf_improved: bool = False) -> np.ndarray:
        """Deprecated alias of :meth:`closeness_batch`."""
        _alias_warning("closeness", "closeness_batch")
        return self.closeness_batch(sources, wf_improved=wf_improved)

    def closeness_sample(self, k: int, *, seed: int = 0
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Sample ``k`` vertices (caller ids) and return
        ``(sources, closeness scores)`` aligned index-by-index."""
        rng = np.random.default_rng(seed)
        srcs = rng.integers(0, self.n, int(k))
        return srcs, self.closeness_batch(srcs)

    def centrality_sample(self, n_sources: int, seed: int = 0
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Deprecated alias of :meth:`closeness_sample`."""
        _alias_warning("centrality_sample", "closeness_sample")
        return self.closeness_sample(n_sources, seed=seed)

    # ------------------------------------------------------------------
    # analytics query kinds (DESIGN §2.6)
    # ------------------------------------------------------------------
    def _cached(self, key, build):
        if key not in self._analytics_cache:
            self._analytics_cache[key] = build()
        return self._analytics_cache[key]

    def _sym_problem(self) -> BlestProblem:
        """The symmetrised twin of the prepared problem (same internal id
        space — symmetrisation commutes with the reordering), on the
        session's device, backing the classical undirected analytics;
        sharded when the session is."""
        return self._cached("sym_problem", lambda: build_problem(
            self.prepared.graph.symmetrized, sigma=self.prepared.bvss.sigma,
            mesh=self.mesh, mesh_axis=self._mesh_axis,
            device=self._problem.device))

    def _sym_ms(self):
        """Wave slot pool over the symmetrised problem (flood-fill)."""
        return self._cached("sym_ms", lambda: make_ms_engine(
            self._sym_problem(), self.max_batch,
            use_kernel=self._use_kernel, **self._seams))

    def _sym_sss(self):
        """Single-source engine on the symmetrised problem (the
        flood-fill's phase-0 giant-component pass)."""
        return self._cached("sym_sss", lambda: make_blest_bfs(
            self._sym_problem(), lazy=False, use_kernels=self._use_kernel))

    def _sym_wave(self, width: int):
        """Cached fixed-cohort multi-source fn on the symmetrised problem
        (eccentricity batches; one per distinct width)."""
        return self._cached(("sym_wave", width), lambda: make_multi_source_bfs(
            None, width, problem=self._sym_problem(),
            use_kernel=self._use_kernel))

    def _dir_wave(self, width: int):
        """Cached fixed-cohort multi-source fn on the session's own
        (directed) problem — closeness cohorts; one per distinct width."""
        return self._cached(("dir_wave", width), lambda: make_multi_source_bfs(
            None, width, problem=self._problem,
            use_kernel=self._use_kernel))

    def components(self) -> np.ndarray:
        """Connected-component labels, one per vertex in caller ids,
        normalised to 0..k-1 in order of each component's smallest caller
        vertex.  Phase 0 floods one component through the single-source
        engine; the wave slot pool then flood-fills the rest, converged
        slots re-seeded from still-untouched vertices."""
        labels = connected_components(engine=self._sym_ms(),
                                      first_flood=self._sym_sss())
        return normalize_labels(labels[self.perm])

    def eccentricity_batch(self, sources: Sequence[int]) -> np.ndarray:
        """Eccentricity of each queried vertex (caller ids in, one value
        per source out), batched through the fixed-cohort multi-source
        engine on the symmetrised problem."""
        srcs = np.asarray(check_sources(sources, self.n), dtype=np.int64)
        if len(srcs) == 0:
            return np.zeros(0, dtype=np.int64)
        internal = self.perm[srcs]
        width = min(self.max_batch, len(srcs))
        return eccentricities(internal, problem=self._sym_problem(),
                              batch=width, use_kernel=self._use_kernel,
                              levels_fn=self._sym_wave(width))

    def eccentricity(self, sources: Sequence[int]) -> np.ndarray:
        """Deprecated alias of :meth:`eccentricity_batch`."""
        _alias_warning("eccentricity", "eccentricity_batch")
        return self.eccentricity_batch(sources)

    def extremes(self, *, max_evals: int | None = None) -> ExtremesReport:
        """iFUB diameter / radius bounds of the largest component
        (center/periphery reported in caller ids)."""
        labels = self.components()
        comp = int(np.bincount(labels).argmax())
        members = np.flatnonzero(labels == comp)
        deg = (self.prepared.graph.out_degree
               + self.prepared.graph.in_degree)[self.perm[members]]
        start = int(members[int(np.argmax(deg))])
        rep = ifub_extremes(problem=self._sym_problem(),
                            start=int(self.perm[start]),
                            batch=self.max_batch,
                            use_kernel=self._use_kernel,
                            max_evals=max_evals,
                            levels_fn=self._sym_wave(self.max_batch))
        inv = self.inv
        return ExtremesReport(
            diameter_lb=rep.diameter_lb, diameter_ub=rep.diameter_ub,
            radius_ub=rep.radius_ub, center=int(inv[rep.center]),
            periphery=int(inv[rep.periphery]),
            n_ecc_evals=rep.n_ecc_evals)

    # ------------------------------------------------------------------
    # betweenness (DESIGN §2.6)
    # ------------------------------------------------------------------
    def _bc_fn(self, width: int):
        """Cached Brandes forward + backward fn on the session's own
        problem (one per distinct width)."""
        return self._cached(("bc_fn", width), lambda: make_betweenness(
            self._problem, width, use_kernel=self._use_kernel,
            spmm_w_impl=self._seams.get("spmm_w_impl")))

    def betweenness_batch(self, sources: Sequence[int]) -> np.ndarray:
        """Partial Brandes betweenness Σ_{s∈sources} δ_s(v) on the
        directed graph (unnormalised, endpoints excluded): one score per
        vertex, caller ids throughout.  Forward phase = the wave BFS with
        the σ path-count channel; backward = the reverse sweep over the
        recorded per-level tile queues."""
        srcs = np.asarray(check_sources(sources, self.n), dtype=np.int64)
        if len(srcs) == 0:
            return np.zeros(self.n, dtype=np.float64)
        internal = self.perm[srcs]
        width = min(self.max_batch, len(srcs))
        bc = betweenness_centrality(None, internal, problem=self._problem,
                                    use_kernel=self._use_kernel,
                                    batch=width, bc_fn=self._bc_fn(width))
        return bc[self.perm]

    def betweenness(self, sources: Sequence[int]) -> np.ndarray:
        """Deprecated alias of :meth:`betweenness_batch`."""
        _alias_warning("betweenness", "betweenness_batch")
        return self.betweenness_batch(sources)

    def betweenness_sample(self, k: int, *, seed: int = 0
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Sample ``k`` distinct pivots (caller ids) and return
        ``(sources, partial betweenness per vertex)`` — the standard
        sampled-source Brandes estimator."""
        rng = np.random.default_rng(seed)
        k = min(int(k), self.n)
        srcs = rng.choice(self.n, size=k, replace=False)
        return srcs, self.betweenness_batch(srcs)

    # ------------------------------------------------------------------
    # weighted verbs (DESIGN §2.9)
    # ------------------------------------------------------------------
    def _weights_ord(self) -> np.ndarray:
        """Per-edge weights in the REORDERED graph's CSR edge order — the
        session's own if it was built with ``weights=...``, else the lazy
        unit-weight default."""
        if self.prepared.weights is not None:
            return self.prepared.weights
        return self._cached("unit_weights", lambda: np.ones(
            self.prepared.graph.m, dtype=np.float32))

    def _wplane(self):
        """The device weight plane the weighted verbs pull against:
        ``prepare``'s committed plane on a weighted session, a lazily built
        (and cached) unit plane otherwise — the same slice layout either
        way, so it aligns with the session's problem bit for bit."""
        if self.prepared.wplane is not None:
            return self.prepared.wplane
        if self._problem.is_2d:
            raise ConfigError(
                "weighted verbs are not supported on a 2-D (row × column) "
                "mesh yet — the weighted verbs ship 1-D row-sharded "
                "(DESIGN §2.9); use a 1-D mesh or a single device")

        def unit_plane():
            g_ord, ones = self.prepared.graph, self._weights_ord()
            sigma = self.prepared.bvss.sigma
            if self.mesh is None:
                return weight_plane_to_device(
                    build_weight_plane(g_ord, ones, sigma=sigma),
                    self._problem.device)
            sb = build_sharded_bvss(
                g_ord, axis_size(self.mesh, self._mesh_axis), sigma=sigma)
            return weight_plane_to_device(
                build_sharded_weight_plane(g_ord, ones, sb),
                self._problem.device, mesh=self.mesh, axis=self._mesh_axis)

        return self._cached("unit_wplane", unit_plane)

    def _sssp_fn(self, width: int):
        """Cached delta-stepping engine of cohort width ``width``."""
        return self._cached(("sssp_fn", width), lambda: make_sssp(
            self._problem, self._wplane(), width,
            use_kernel=self._use_kernel))

    def sssp(self, src: int, *, delta: float | None = None) -> np.ndarray:
        """Single-source shortest-path distances from ``src`` (caller ids
        in and out): one float64 distance per vertex, ``+inf`` where
        unreachable.  Delta-stepping over the min-plus tile product
        against the session's weight plane (unit weights on an unweighted
        session, where this equals BFS hop counts).  ``delta`` overrides
        the bucket width (performance only, never correctness)."""
        src = check_source(src, self.n)
        dist = sssp_distances(
            [int(self.perm[src])], problem=self._problem,
            wplane=self._wplane(), weights=self._weights_ord(), batch=1,
            delta=delta, sssp_fn=self._sssp_fn(1))
        return dist[0][self.perm]

    def sssp_batch(self, sources: Sequence[int], *,
                   delta: float | None = None) -> np.ndarray:
        """Distances from each source (rows, aligned with ``sources``) to
        every vertex (cols): (S, n) float64, caller ids throughout.
        Cohorts of ``max_batch`` stacked distance columns share one
        min-plus tile stream."""
        srcs = np.asarray(check_sources(sources, self.n), dtype=np.int64)
        if len(srcs) == 0:
            return np.zeros((0, self.n), dtype=np.float64)
        width = min(self.max_batch, len(srcs))
        dist = sssp_distances(
            self.perm[srcs], problem=self._problem, wplane=self._wplane(),
            weights=self._weights_ord(), batch=width, delta=delta,
            sssp_fn=self._sssp_fn(width))
        return dist[:, self.perm]

    def pagerank(self, *, damping: float = 0.85, tol: float = 1e-8,
                 max_iter: int = 200) -> np.ndarray:
        """PageRank scores, one per vertex in caller-id order (sums to 1):
        damped power iteration with dangling-mass correction over the
        float tile product (DESIGN §2.9).  STRUCTURAL PageRank — session
        edge weights do not influence the scores."""
        fn = self._cached(
            ("pagerank_fn", float(damping), float(tol), int(max_iter)),
            lambda: make_pagerank(
                self._problem, out_degrees(self.prepared.graph),
                use_kernel=self._use_kernel, damping=damping, tol=tol,
                max_iter=max_iter))
        return pagerank_scores(pagerank_fn=fn)[self.perm]
