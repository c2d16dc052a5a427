"""BLEST's static execution policy (paper §5, Table 2 "full" variant), the
single-device part of ``repro/core/policy.py``.

The paper's pipeline makes two static decisions per graph:
  1. ordering: social-like -> JaccardWithWindows (+pre-pass); else RCM;
  2. update scheme: lazy vertex updates only when the update divergence
     exceeds a threshold (paper: 25,000).

``prepare(graph)`` runs the whole static pipeline on the host (NumPy, the
same arrays as the reference) and returns a ready engine on the device:
the card unless the options say ``device="cpu"``.  ``autotune=True``
measures the hybrid's ladder and push cap for the device first
(``core/autotune.py``); streaming edge updates evolve the result through
:func:`repro_torch.core.bvss_delta.apply_edge_updates` (DESIGN §2.10).

``prepare(graph, mesh=...)`` is the one SHARDED preparation too (DESIGN
§2.4): the same order/scheme decisions run on the global BVSS on every
rank, then each rank builds its own shard of the row-sharded problem and
the engines run the same level loop on every rank of the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.autotune import TileConfig, tune
from repro_torch.core.bfs import BlestProblem, make_engine
from repro_torch.core.bvss import (BVSS, build_bvss, build_sharded_bvss,
                                   build_sharded_weight_plane,
                                   build_weight_plane, resolve_device,
                                   weight_plane_to_device)
from repro_torch.core.ordering import auto_order
from repro_torch.distributed.bfs_dist import mesh_is_2d, mesh_rank_device
from repro_torch.distributed.collectives import axis_size
from repro_torch.errors import (BlestError, ConfigError, check_source,
                                check_weights)
from repro_torch.graphs import Graph, src_of_edges

# paper §5: fixed threshold for switching to lazy vertex updates
LAZY_UDIV_THRESHOLD = 25_000.0
# at lab scale the same mechanism is exercised with a proportional
# threshold (the paper's constant assumes 23M+ vertex graphs)
LAZY_UDIV_FRACTION = 0.1


@dataclasses.dataclass(frozen=True, eq=False)
class PrepareOptions:
    """Every static knob of :func:`prepare`, as one typed value::

        prepare(g, options=PrepareOptions(sigma=4, device="cpu"))

    ``weights`` may be an array; options compare by identity.
    """

    sigma: int = 8                        # slice width (bits)
    w: int = 512                          # ordering window
    seed: int = 0                         # ordering shingle seed
    lazy_threshold: float | None = None   # lazy-update divergence override
    order: bool = True                    # run the ordering pre-pass
    engine: str | None = None             # explicit engine override
    use_kernels: bool = True              # kernel entry points vs twins
    buckets: int = 2                      # queue-width ladder graduations
    direction: str = "auto"               # push/pull hybrid mode
    autotune: bool = False                # measure hybrid knobs per device
    push_impl: Callable | None = None     # push-kernel seam
    device: str | None = None             # None = "cuda"; "cpu" on request
    mesh: object | None = None            # row-shard over this DeviceMesh
    mesh_axis: str = "data"               # row axis name of the mesh
    weights: np.ndarray | None = None     # per-edge weights of the INPUT g

    def replace(self, **changes) -> "PrepareOptions":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class PreparedBFS:
    graph: Graph           # reordered graph
    perm: np.ndarray       # old id -> new id
    inv: np.ndarray        # new id -> old id (perm's inverse)
    ordering: str
    engine_name: str
    bvss: BVSS
    # device-resident BVSS bundle, shared with the engine; None when the
    # prepared engine is a CSR/dense baseline that never touches the BVSS
    problem: BlestProblem | None
    device: torch.device   # where the engine runs
    update_divergence: float
    options: PrepareOptions
    _fn: Callable[[int], torch.Tensor] | None = dataclasses.field(default=None)
    # mesh the problem is row-sharded over; None = single-device
    mesh: object | None = None
    # per-edge weights in the REORDERED graph's CSR edge order (float32)
    # and their device weight plane, when prepared with weights
    weights: np.ndarray | None = None
    wplane: torch.Tensor | None = None
    # winning hybrid knobs when prepared with autotune=True (DESIGN §2.8);
    # None = defaults were used.  ``tile_config.source == "cached"`` means
    # this prepare() re-used an earlier measurement (nothing timed)
    tile_config: TileConfig | None = None
    # epoch version of the prepared state (DESIGN §2.10): bumped by every
    # apply_edge_updates, which builds the next epoch's device tensors anew
    # and never writes the old ones, so in-flight waves finish on the
    # epoch they were built against
    epoch: int = 0
    # cumulative edges patched since the last FULL build — the staleness
    # ledger apply_edge_updates charges its budget against
    stale_edges: int = 0
    # the UpdateReport of the apply_edge_updates call that produced this
    # epoch (None on a fresh preparation)
    last_update: "object | None" = None

    def levels(self, src: int) -> np.ndarray:
        """BFS levels in the caller's (original) vertex ids."""
        if self._fn is None:
            raise BlestError("PreparedBFS built without an engine")
        src = check_source(src, self.graph.n)
        lv = self._fn(int(self.perm[src])).cpu().numpy()
        return lv[self.perm]


def choose_update_scheme(bvss: BVSS, *, threshold: float | None = None
                         ) -> str:
    """Paper §5: lazy updates iff the update divergence is high (scattered
    updates dominate) — otherwise the eager scheme avoids the Θ(n) sweep."""
    udiv = bvss.update_divergence()
    if threshold is None:
        threshold = min(LAZY_UDIV_THRESHOLD, LAZY_UDIV_FRACTION * bvss.n)
    return "blest_lazy" if udiv > threshold else "blest"


#: engines that run on the device BVSS (``prepare`` builds the problem
#: only for these; the CSR and dense baselines build their own arrays)
BVSS_ENGINES = ("brs", "blest", "blest_lazy")


def build_problem(g_ord: Graph, *, sigma: int = 8, mesh=None,
                  mesh_axis: str = "data", bvss: BVSS | None = None,
                  options: PrepareOptions | None = None,
                  device: "str | torch.device | None" = None
                  ) -> BlestProblem:
    """Build the device problem for an (already ordered) graph: single-
    device, 1-D row-sharded, or 2-D row × column-sharded depending on the
    mesh — the one dispatch every problem-building caller (``prepare``,
    the serving tier's symmetrised problem) routes through.  A 2-D mesh
    (two named dimensions) partitions by ``(rows, cols) = mesh.shape``;
    a 1-D one over its ``mesh_axis``.  Each rank keeps only its own shard
    (:func:`~repro_torch.core.bvss.shard_to_device`), on its own device
    (:func:`~repro_torch.distributed.bfs_dist.mesh_rank_device`: a mesh
    of another device type than ``device`` is a
    :class:`~repro_torch.errors.ConfigError`).  ``options`` supplies
    ``sigma``, ``mesh``, ``mesh_axis`` and ``device`` in one value (an
    explicitly passed keyword wins)."""
    if options is not None:
        sigma = options.sigma if sigma == 8 else sigma
        mesh = options.mesh if mesh is None else mesh
        mesh_axis = options.mesh_axis if mesh_axis == "data" else mesh_axis
        device = options.device if device is None else device
    if mesh is None:
        if bvss is None:
            bvss = build_bvss(g_ord, sigma=sigma)
        return BlestProblem.build(bvss, device)
    mesh_rank_device(mesh, device)          # a DeviceMesh of device's type
    if mesh_is_2d(mesh):
        sb = build_sharded_bvss(g_ord, tuple(mesh.shape), sigma=sigma)
        return BlestProblem.build_sharded_2d(sb, mesh, device)
    sb = build_sharded_bvss(g_ord, axis_size(mesh, mesh_axis), sigma=sigma)
    return BlestProblem.build_sharded(sb, mesh, mesh_axis, device)


def prepare(g: Graph, options: PrepareOptions | None = None,
            **fields) -> PreparedBFS:
    """The full static pipeline: (optionally) order, build the BVSS, pick
    the update scheme (or honour an explicit ``engine``), build the engine
    on the device.

    Configuration is one :class:`PrepareOptions` value; keyword ``fields``
    override its fields (``prepare(g, device="cpu")``).  With no CUDA
    device and no ``device="cpu"``, this raises
    :class:`~repro_torch.errors.ConfigError` before any work: the port
    never quietly runs on the CPU.

    ``mesh`` (a :class:`torch.distributed.device_mesh.DeviceMesh` from
    :func:`~repro_torch.distributed.bfs_dist.bfs_mesh` or ``bfs_mesh2d``)
    row-shards the problem over ``mesh_axis`` (2-D: rows × columns) and
    builds the mesh-native engine (DESIGN §2.4).  Every rank calls
    ``prepare`` on the same graph; the policy decisions come from the
    global BVSS, each rank keeps its own shard on its own device
    (``cuda:r``, or the CPU for a gloo mesh with ``device="cpu"``), and
    ``levels(src)`` answers the whole graph on every rank.  Only the BVSS
    engines shard (others raise ``ValueError``), and weights need a 1-D
    mesh."""
    o = (options if options is not None else PrepareOptions()).replace(
        **fields)
    if o.mesh is None:
        device = resolve_device(o.device)
    else:
        device = mesh_rank_device(o.mesh, o.device)
    w_arr = None if o.weights is None else check_weights(o.weights, g.m)
    if o.order:
        perm, kind = auto_order(g, sigma=o.sigma, w=o.w, seed=o.seed)
        g_ord = g.permute_fast(perm)
    else:
        perm, kind = np.arange(g.n, dtype=np.int64), "natural"
        g_ord = g
    inv = np.empty(g.n, dtype=np.int64)
    inv[perm] = np.arange(g.n)
    w_ord = None
    if w_arr is not None:
        if o.order:
            # permute_fast re-sorts the relabelled edges by (src·n + dst)
            # key; simple-graph keys are unique, so a stable argsort maps
            # each ordered edge back to its original weight
            keys = (perm[src_of_edges(g)] * np.int64(g.n)
                    + perm[g.indices.astype(np.int64)])
            w_ord = w_arr[np.argsort(keys, kind="stable")]
        else:
            w_ord = w_arr
    bvss = build_bvss(g_ord, sigma=o.sigma)
    engine_name = o.engine if o.engine is not None else \
        choose_update_scheme(bvss, threshold=o.lazy_threshold)
    wplane = None
    if o.mesh is not None:
        if engine_name not in BVSS_ENGINES:
            raise ValueError(
                f"mesh-native prepare supports the BVSS engines "
                f"{BVSS_ENGINES}, not {engine_name!r} (the CSR/dense "
                f"baselines have no row-sharded representation)")
        if w_ord is not None and mesh_is_2d(o.mesh):
            raise ConfigError(
                "edge weights are not supported on a 2-D (row × column) "
                "mesh yet — the weighted verbs ship 1-D row-sharded "
                "(DESIGN §2.9); use a 1-D mesh or a single device")
        if w_ord is not None:
            # build the sharded BVSS once and derive both the problem and
            # this rank's aligned weight plane from it
            sb = build_sharded_bvss(g_ord, axis_size(o.mesh, o.mesh_axis),
                                    sigma=o.sigma)
            problem = BlestProblem.build_sharded(sb, o.mesh, o.mesh_axis,
                                                 device)
            wplane = weight_plane_to_device(
                build_sharded_weight_plane(g_ord, w_ord, sb), device,
                mesh=o.mesh, axis=o.mesh_axis)
        else:
            problem = build_problem(g_ord, sigma=o.sigma, mesh=o.mesh,
                                    mesh_axis=o.mesh_axis, device=o.device)
    else:
        problem = build_problem(g_ord, bvss=bvss, device=device) \
            if engine_name in BVSS_ENGINES else None
        if w_ord is not None:
            wplane = weight_plane_to_device(
                build_weight_plane(g_ord, w_ord, sigma=o.sigma), device)
    tile_config: TileConfig | None = None
    tuned_kwargs: dict = {}
    if o.autotune and problem is not None:
        tile_config = tune(problem, use_kernels=o.use_kernels)
        tuned_kwargs = tile_config.engine_kwargs()
    fn = make_engine(g_ord, engine_name, bvss=bvss, problem=problem,
                     device=device, use_kernels=o.use_kernels,
                     buckets=o.buckets, direction=o.direction,
                     push_impl=o.push_impl, **tuned_kwargs)
    return PreparedBFS(graph=g_ord, perm=perm, inv=inv, ordering=kind,
                       engine_name=engine_name, bvss=bvss, problem=problem,
                       device=device,
                       update_divergence=bvss.update_divergence(),
                       options=o, _fn=fn, mesh=o.mesh, weights=w_ord,
                       wplane=wplane, tile_config=tile_config)


def parents_from_levels(g: Graph, levels: np.ndarray) -> np.ndarray:
    """BFS parent array (paper §2: the kernel may return either form).

    Pull semantics: parent[u] is any in-neighbour of u at level[u]-1 (the
    first in in-CSR order).  One vectorised NumPy sweep over the in-CSR."""
    INF = np.iinfo(np.int32).max
    t_indptr, t_indices = g.t_csr
    levels = np.asarray(levels)
    u_of = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(t_indptr))
    lu = levels[u_of]
    nbrs = t_indices.astype(np.int64)
    ok = (lu != 0) & (lu != INF) & (levels[nbrs] == lu - 1)
    parents = np.full(g.n, -1, dtype=np.int64)
    idx = np.flatnonzero(ok)
    if len(idx):
        # first qualifying in-edge per vertex: idx ascends within each
        # CSR row, so unique's first occurrence is the CSR-order choice
        uu, first = np.unique(u_of[idx], return_index=True)
        parents[uu] = nbrs[idx[first]]
    return parents
