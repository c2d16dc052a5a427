"""BLEST's static execution policy (paper §5, Table 2 "full" variant), the
single-device part of ``repro/core/policy.py``.

The paper's pipeline makes two static decisions per graph:
  1. ordering: social-like -> JaccardWithWindows (+pre-pass); else RCM;
  2. update scheme: lazy vertex updates only when the update divergence
     exceeds a threshold (paper: 25,000).

``prepare(graph)`` runs the whole static pipeline on the host (NumPy, the
same arrays as the reference) and returns a ready engine on the device:
the card unless the options say ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.bfs import BlestProblem, make_engine
from repro_torch.core.bvss import (BVSS, build_bvss, build_weight_plane,
                                   resolve_device, weight_plane_to_device)
from repro_torch.core.ordering import auto_order
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
    push_impl: Callable | None = None     # push-kernel seam
    device: str | None = None             # None = "cuda"; "cpu" on request
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
    problem: BlestProblem  # device-resident BVSS bundle, shared with the engine
    update_divergence: float
    options: PrepareOptions
    _fn: Callable[[int], torch.Tensor] | None = dataclasses.field(default=None)
    # per-edge weights in the REORDERED graph's CSR edge order (float32)
    # and their device weight plane, when prepared with weights
    weights: np.ndarray | None = None
    wplane: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.problem.device

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


def build_problem(g_ord: Graph, *, sigma: int = 8, mesh=None,
                  bvss: BVSS | None = None,
                  device: "str | torch.device | None" = None
                  ) -> BlestProblem:
    """Build the device problem for an (already ordered) graph — the one
    dispatch every problem-building caller (``prepare``, the serving
    tier's symmetrised problem) routes through.  Single-device only: a
    ``mesh`` is a :class:`~repro_torch.errors.ConfigError` (the mesh
    paths are ROADMAP.md queue 1 item 11)."""
    if mesh is not None:
        raise ConfigError(
            "mesh-sharded problems are not ported to PyTorch yet: they come "
            "with the mesh slice (ROADMAP.md queue 1 item 11)")
    if bvss is None:
        bvss = build_bvss(g_ord, sigma=sigma)
    return BlestProblem.build(bvss, device)


def prepare(g: Graph, options: PrepareOptions | None = None,
            **fields) -> PreparedBFS:
    """The full static pipeline: (optionally) order, build the BVSS, pick
    the update scheme (or honour an explicit ``engine``), build the engine
    on the device.

    Configuration is one :class:`PrepareOptions` value; keyword ``fields``
    override its fields (``prepare(g, device="cpu")``).  With no CUDA
    device and no ``device="cpu"``, this raises
    :class:`~repro_torch.errors.ConfigError` before any work: the port
    never quietly runs on the CPU."""
    o = (options if options is not None else PrepareOptions()).replace(
        **fields)
    device = resolve_device(o.device)
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
    problem = build_problem(g_ord, bvss=bvss, device=device)
    wplane = None if w_ord is None else weight_plane_to_device(
        build_weight_plane(g_ord, w_ord, sigma=o.sigma), device)
    fn = make_engine(g_ord, engine_name, problem=problem,
                     use_kernels=o.use_kernels, buckets=o.buckets,
                     direction=o.direction, push_impl=o.push_impl)
    return PreparedBFS(graph=g_ord, perm=perm, inv=inv, ordering=kind,
                       engine_name=engine_name, bvss=bvss, problem=problem,
                       update_divergence=bvss.update_divergence(),
                       options=o, _fn=fn, weights=w_ord, wplane=wplane)


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
