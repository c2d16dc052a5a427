"""Fault injection for the hardened serving tier (DESIGN §2.7), the port of
``repro/serve/faults.py``.

A :class:`FaultPlan` is handed to the engine *builder* and its wrappers sit
exactly at the seams of :func:`repro_torch.core.multi_source.make_ms_engine`
and :func:`repro_torch.core.bfs.make_blest_bfs`, around the hand-written
CUDA kernels (their PyTorch twins on CPU tensors):

* ``corrupt_spmm_tile`` — ``spmm_impl``, around ``bvss_spmm``: the first
  queued VSS tile's popcounts are forced positive, so its rows are
  "discovered" a level early.  A silent wrong answer unless the
  verify-mode sampling of :mod:`repro_torch.serve.session_manager`
  catches it.
* ``corrupt_push_tile`` — ``push_impl``, around ``bvss_push``: every row of
  the first queued (vertex, VSS) pair reads as hit.  Only push levels of
  the single-source engines are affected (a session with a push seam takes
  the unfused push level, never ``bvss_push_level``); the wave engine's
  push rides the bit-SpMM seam and is covered by ``corrupt_spmm_tile``.
* ``nan_sigma`` — ``spmm_w_impl``, around ``bvss_spmm_w``: the σ
  path-count float channel is NaN-poisoned where the tile contributed.
  Betweenness scores go NaN; the finite guard must degrade to the host
  oracle.
* ``stall_shard`` — ``gather_impl``, the frontier exchange of the mesh
  wave engines: shard k's segment of the all-gathered frontier words
  arrives zeroed (a stalled peer), so the vertices it owns stop
  propagating and other shards under-discover.
* ``stall_butterfly_stage`` — the same seam: stage k of the butterfly
  frontier exchange (``distributed.collectives.
  butterfly_frontier_exchange``) drops its partner block, the 2-D
  analogue of ``stall_shard``.  A plan may set one stall or the other,
  never both.  Only the wave pools of a mesh session consult the seam,
  as in the reference: on one device a stall plan is accepted and inert,
  and at world size 1 a butterfly has no stage.

Each wrapper is a torch op on the kernel's output, out of place, so the
kernel itself runs unchanged.  Every injected fault must surface as a
typed error or a degraded-but-correct result, never a silent wrong answer
(``tests/test_torch_faults.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.distributed.bfs_dist import frontier_all_gather
from repro_torch.distributed.collectives import butterfly_frontier_exchange
from repro_torch.errors import ConfigError
from repro_torch.kernels import bvss_spmm, bvss_spmm_w, push_vss_kernel
from repro_torch.kernels.ref import (bvss_push_ref, bvss_spmm_ref,
                                     bvss_spmm_w_ref)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Static description of the faults to bake into an engine build.

    The default plan injects nothing and adds nothing to any engine; a plan
    is immutable, so one engine build corresponds to one fault
    configuration.
    """

    #: corrupt the Boolean bit-SpMM: force the first queued tile's
    #: popcounts positive (rows discovered a level early — wrong levels)
    corrupt_spmm_tile: bool = False
    #: corrupt the push kernel's first tile (single-source push levels):
    #: every row of the first queued (vertex, VSS) pair reads as hit
    corrupt_push_tile: bool = False
    #: NaN-poison the weighted σ tile product (Brandes float channel)
    nan_sigma: bool = False
    #: zero shard k's segment of the frontier-word all-gather (stalled
    #: peer); only consulted by mesh engines
    stall_shard: int | None = None
    #: drop the partner block at stage k of the butterfly frontier
    #: exchange; shares the ``gather_impl`` seam with ``stall_shard``
    stall_butterfly_stage: int | None = None

    def __post_init__(self):
        if (self.stall_shard is not None
                and self.stall_butterfly_stage is not None):
            raise ConfigError(
                "stall_shard and stall_butterfly_stage both occupy the "
                "gather_impl seam; a plan may set at most one")

    @property
    def injects(self) -> bool:
        return (self.corrupt_spmm_tile or self.corrupt_push_tile
                or self.nan_sigma or self.stall_shard is not None
                or self.stall_butterfly_stage is not None)

    # -- seam wrappers ---------------------------------------------------
    def wrap_spmm(self, base: Callable) -> Callable:
        if not self.corrupt_spmm_tile:
            return base

        def faulty_spmm(masks, fbytes, *, sigma=8, **kw):
            counts = base(masks, fbytes, sigma=sigma, **kw).clone()
            # corrupt tile 0: every row of the first queued VSS reads as
            # adjacent to the frontier, whatever the masks said
            counts[0].clamp_(min=1)
            return counts

        return faulty_spmm

    def wrap_push(self, base: Callable) -> Callable:
        if not self.corrupt_push_tile:
            return base

        def faulty_push(masks, bits, sigma=8, **kw):
            # the engines pass σ positionally; the bases take it by keyword
            hits = base(masks, bits, sigma=sigma, **kw).clone()
            # corrupt tile 0: the first queued (vertex, VSS) pair claims
            # every row of its tile, whatever the masks said
            hits[0] = True
            return hits

        return faulty_push

    def wrap_spmm_w(self, base: Callable) -> Callable:
        if not self.nan_sigma:
            return base

        def faulty_spmm_w(masks, xvals, *, sigma=8, **kw):
            out = base(masks, xvals, sigma=sigma, **kw)
            # poison only where the tile contributed: NaN * 0 stays 0 on
            # rows the pull never touched, which is how a bad lane
            # corrupts real traffic only
            return out * torch.where(out != 0, float("nan"),
                                     1.0).to(out.dtype)

        return faulty_spmm_w

    def wrap_gather(self) -> Callable | None:
        """The stalled frontier exchange ``gather(words, mesh, axis)`` of
        this plan, or None."""
        if self.stall_butterfly_stage is not None:
            return functools.partial(
                butterfly_frontier_exchange,
                stall_stage=int(self.stall_butterfly_stage))
        if self.stall_shard is None:
            return None
        k = int(self.stall_shard)

        def stalled_gather(fw_local, mesh, axis):
            full = frontier_all_gather(fw_local, mesh, axis)
            lw = fw_local.shape[0]
            # shard k's words arrive zeroed: its frontier never reaches
            # the other shards' pull operands
            full[k * lw:(k + 1) * lw] = 0
            return full

        return stalled_gather

    # -- engine-builder kwargs ------------------------------------------
    def engine_overrides(self, *, use_kernel: bool = True) -> dict:
        """kwargs for :func:`repro_torch.core.multi_source.make_ms_engine`
        (and friends) that bake this plan's faults into the build.  An
        empty dict when the plan injects nothing, so the unfaulted path is
        the session's ordinary one."""
        if not self.injects:
            return {}
        out: dict = {}
        if self.corrupt_spmm_tile:
            out["spmm_impl"] = self.wrap_spmm(
                bvss_spmm if use_kernel else bvss_spmm_ref)
        if self.corrupt_push_tile:
            out["push_impl"] = self.wrap_push(
                push_vss_kernel if use_kernel else bvss_push_ref)
        if self.nan_sigma:
            out["spmm_w_impl"] = self.wrap_spmm_w(
                bvss_spmm_w if use_kernel else bvss_spmm_w_ref)
        if (self.stall_shard is not None
                or self.stall_butterfly_stage is not None):
            out["gather_impl"] = self.wrap_gather()
        return out


#: the no-op plan every un-faulted session uses
NO_FAULTS = FaultPlan()
