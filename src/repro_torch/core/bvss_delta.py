"""Incremental BVSS maintenance: streaming edge updates without a full
re-``prepare`` (DESIGN §2.10), the port of ``repro/core/bvss_delta.py``.

:func:`apply_edge_updates` evolves a
:class:`~repro_torch.core.policy.PreparedBFS` through a batch of edge
insertions / deletions.  The slice-set layout makes this local:
:func:`~repro_torch.core.bvss.build_bvss` lays every slice set out
contiguously — slices sorted by row, packed column-major over
``(slot, lane)`` into the set's own VSS range — so an edge ``(s, d)`` only
perturbs slice set ``s // σ``, and re-laying out just the touched sets
reproduces a fresh build BIT FOR BIT as long as no touched set's VSS count
changes (``real_ptrs`` / ``virtual_to_real`` / ``num_vss`` are then
invariant).  The weight plane shares the slice placement, so its touched
rows are recomputed the same way.

Three maintenance paths, cheapest first:

* **patched** — every touched set keeps its VSS count (globally and, on a
  1-D mesh, in every shard): mask words, row ids and weight-plane entries
  of the touched VSS rows are rewritten on the host and copied into NEW
  device tensors (a clone of the old one with the
  touched rows replaced, ``index_copy_`` on the clone).  The old epoch's
  tensors are never written — torch tensors are mutable, unlike the
  reference's JAX arrays, so the clone is what keeps waves in flight on
  the previous epoch on exactly the bits they started with.  The
  ``BVSSDevice`` fields a patch cannot change (``virtual_to_real``,
  ``real_ptrs``, ``vss_of_vertex_start/end``) are shared between epochs.
* **rebuilt** — a touched set's VSS count changed (or the problem is 2-D
  partitioned, whose interleaved column relabelling makes locality moot):
  the BVSS, problem and plane are rebuilt from scratch over the SAME vertex
  ordering, keeping the caller-id contract and the epoch ledger.
* **reprepared** — the cumulative patched-edge ledger crossed the
  staleness budget: the ordering itself is presumed stale, so the
  ORIGINAL graph is reconstructed in caller ids and the whole static
  pipeline re-runs, new ordering included, with the same options (device,
  push seam and autotune carry over).

Updates are addressed in the caller's ORIGINAL vertex ids and remapped
through ``prepared.perm`` internally — the same id contract as every query
verb.  Every path returns a NEW ``PreparedBFS`` with ``epoch + 1`` (the
input value is never mutated); pass ``expected_epoch`` for a
compare-and-swap that raises :class:`~repro_torch.errors.StaleEpochError`
instead of merging onto a superseded base.

On a mesh (SPMD, every rank calling with the same batch) each rank holds
only its own shard, so it patches only its own block's rows.  The choice
among patch, rebuild and reprepare comes from host data every rank holds
alike — the caller graph, the ordering and every shard's VSS offsets
(``BlestProblem.shard_ptrs``) — so every rank takes the same path, and
the collectives of the next query line up.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bfs import BlestProblem, make_engine
from repro_torch.core.bvss import (BVSS, LANES, build_bvss,
                                   build_sharded_bvss,
                                   build_sharded_weight_plane,
                                   build_weight_plane, weight_plane_to_device)
from repro_torch.core.policy import (BVSS_ENGINES, PreparedBFS,
                                     PrepareOptions, build_problem, prepare)
from repro_torch.distributed.collectives import axis_size
from repro_torch.errors import (ConfigError, GraphValidationError,
                                StaleEpochError, check_weights)
from repro_torch.graphs import Graph, from_edges, src_of_edges

#: default staleness budget, as a fraction of the CURRENT edge count:
#: once the cumulative patched-edge ledger exceeds it, the next update
#: falls back to a full re-``prepare`` (ordering re-runs on the mutated
#: graph).  Deliberately generous — the ordering degrades slowly.
STALENESS_FRACTION = 0.25


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What one :func:`apply_edge_updates` call actually did."""

    path: str                 # "patched" | "rebuilt" | "reprepared"
    epoch: int                # epoch of the RETURNED PreparedBFS
    n_inserted: int
    n_deleted: int
    n_reweighted: int         # inserts that re-weighted an existing edge
    sets_touched: int         # slice sets whose layout was recomputed
    vss_rows_rewritten: int   # device VSS rows rewritten (patched path)
    stale_edges: int          # cumulative ledger after this update
    reason: str | None = None  # why a fallback path was taken


def _decode_set(masks: np.ndarray, row_ids: np.ndarray, sigma: int,
                dummy_row: int) -> dict[int, int]:
    """Row -> σ-bit mask of one slice set's VSS rows (the inverse of the
    Fig. 2(c) packing: slice k sits at lane ``k % 32``, slot ``k // 32``)."""
    spw = 32 // sigma
    sub_mask = (1 << sigma) - 1
    out: dict[int, int] = {}
    for v in range(masks.shape[0]):
        for slot in range(spw):
            sub = (masks[v] >> np.uint32(slot * sigma)) & np.uint32(sub_mask)
            live = np.flatnonzero(sub)
            for lane in live:
                row = int(row_ids[v, slot, lane])
                if row != dummy_row:
                    out[row] = out.get(row, 0) | int(sub[lane])
    return out


def _encode_set(slices: dict[int, int], n_vss: int, sigma: int,
                dummy_row: int) -> tuple[np.ndarray, np.ndarray]:
    """Re-pack a set's slices exactly like :func:`build_bvss` would: rows
    ascending, slice k -> (slot k // 32, lane k % 32), zero-mask /
    dummy-row padding to the set's ``n_vss`` VSS rows."""
    spw = 32 // sigma
    tau = LANES * spw
    masks = np.zeros((n_vss, LANES), dtype=np.uint32)
    row_ids = np.full((n_vss, spw, LANES), dummy_row, dtype=np.int32)
    for k, row in enumerate(sorted(slices)):
        v, kk = k // tau, k % tau
        lane, slot = kk % LANES, kk // LANES
        masks[v, lane] |= np.uint32(slices[row]) << np.uint32(slot * sigma)
        row_ids[v, slot, lane] = row
    return masks, row_ids


def _weight_rows(slices: dict[int, int], n_vss: int, sigma: int,
                 set_id: int, weight_of) -> np.ndarray:
    """The touched set's weight-plane rows under the same packing:
    entry ``[v, slot, lane, b]`` = weight of edge ``σ·set_id + b -> row``,
    +inf where the mask bit is unset (the tropical annihilator)."""
    spw = 32 // sigma
    tau = LANES * spw
    plane = np.full((n_vss, spw, LANES, sigma), np.inf, dtype=np.float32)
    for k, row in enumerate(sorted(slices)):
        v, kk = k // tau, k % tau
        lane, slot = kk % LANES, kk // LANES
        m = slices[row]
        for b in range(sigma):
            if (m >> b) & 1:
                plane[v, slot, lane, b] = weight_of(set_id * sigma + b, row)
    return plane


def _edge_batch(edges, n: int, what: str) -> np.ndarray:
    """Validate an edge batch to (k, 2) int64 in-range, loop-free."""
    arr = np.asarray(edges, dtype=np.int64) if len(edges) else \
        np.zeros((0, 2), dtype=np.int64)
    if arr.ndim != 2 or (arr.size and arr.shape[1] != 2):
        raise GraphValidationError(
            f"{what} must be a (k, 2) array of (src, dst) pairs, got shape "
            f"{arr.shape}")
    if arr.size:
        if int(arr.min()) < 0 or int(arr.max()) >= n:
            bad = arr[((arr < 0) | (arr >= n)).any(axis=1)]
            raise GraphValidationError(
                f"{what} contain out-of-range vertex ids "
                f"{bad[:4].tolist()} (valid ids are 0..{n - 1})")
        loops = arr[:, 0] == arr[:, 1]
        if loops.any():
            raise GraphValidationError(
                f"{what} contain self loops at rows "
                f"{np.flatnonzero(loops)[:8].tolist()} (simple graphs only)")
    return arr


def apply_edge_updates(prepared: PreparedBFS, inserts=(), deletes=(), *,
                       insert_weights=None,
                       expected_epoch: int | None = None,
                       staleness_budget: int | None = None) -> PreparedBFS:
    """Apply a batch of edge updates and return the next-epoch
    :class:`~repro_torch.core.policy.PreparedBFS` (the input is never
    mutated; in-flight waves finish on the old epoch's device tensors).

    ``inserts`` / ``deletes`` are ``(k, 2)`` arrays of ``(src, dst)``
    pairs in the caller's ORIGINAL vertex ids.  Inserting an edge that
    already exists is a weight update on a weighted preparation and a
    no-op otherwise; deleting a missing edge is a
    :class:`~repro_torch.errors.GraphValidationError` (a silent no-op would
    let a desynchronised updater believe its view of the graph).
    ``insert_weights`` (one strictly positive float per insert) is
    required when the preparation carries weights and rejected when it
    does not.  ``expected_epoch`` arms the compare-and-swap
    (:class:`~repro_torch.errors.StaleEpochError` on mismatch);
    ``staleness_budget`` overrides the re-``prepare`` fallback threshold
    (edges; default ``STALENESS_FRACTION`` of the current edge count).
    ``prepared.last_update`` on the result records which maintenance path
    ran (:class:`UpdateReport`)."""
    if expected_epoch is not None and expected_epoch != prepared.epoch:
        raise StaleEpochError(
            f"edge updates were computed against epoch {expected_epoch} "
            f"but the prepared state is at epoch {prepared.epoch} — "
            f"recompute the delta on the current epoch",
            expected=expected_epoch, actual=prepared.epoch)
    g_ord = prepared.graph
    n = g_ord.n
    ins = _edge_batch(inserts, n, "inserts")
    del_ = _edge_batch(deletes, n, "deletes")
    weighted = prepared.weights is not None
    if weighted and len(ins) and insert_weights is None:
        raise GraphValidationError(
            "this preparation carries edge weights — every insert needs a "
            "weight (pass insert_weights)")
    if not weighted and insert_weights is not None:
        raise ConfigError(
            "insert_weights given but the preparation is unweighted — "
            "prepare(..., weights=...) first")
    w_ins = check_weights(insert_weights, len(ins),
                          what="insert_weights") if weighted and len(ins) \
        else np.zeros(len(ins), dtype=np.float32)

    # remap caller ids -> internal (ordered) ids; all work below is in the
    # ordered id space, where the CSR edge order IS ascending (src·n + dst)
    perm = prepared.perm
    ins_keys = perm[ins[:, 0]] * n + perm[ins[:, 1]] if len(ins) else \
        np.zeros(0, dtype=np.int64)
    del_keys = perm[del_[:, 0]] * n + perm[del_[:, 1]] if len(del_) else \
        np.zeros(0, dtype=np.int64)
    for name, keys in (("inserts", ins_keys), ("deletes", del_keys)):
        if len(np.unique(keys)) != len(keys):
            raise GraphValidationError(
                f"{name} contain duplicate edges in one batch")
    if len(ins_keys) and len(del_keys) and \
            np.intersect1d(ins_keys, del_keys).size:
        raise GraphValidationError(
            "an edge appears in both inserts and deletes of one batch — "
            "order is ambiguous; split into two update calls")

    old_keys = src_of_edges(g_ord).astype(np.int64) * n \
        + g_ord.indices.astype(np.int64)
    if len(del_keys):
        pos = np.searchsorted(old_keys, del_keys)
        missing = pos >= len(old_keys)
        inb = ~missing
        missing[inb] = old_keys[pos[inb]] != del_keys[inb]
        if missing.any():
            bad = del_[missing][:4]
            raise GraphValidationError(
                f"deletes contain edges not in the graph: "
                f"{bad.tolist()} (caller ids)")
    exists = np.zeros(len(ins_keys), dtype=bool)
    if len(ins_keys) and len(old_keys):
        pos = np.searchsorted(old_keys, ins_keys)
        exists = (pos < len(old_keys)) & (old_keys[np.minimum(
            pos, len(old_keys) - 1)] == ins_keys)
    reweights = ins_keys[exists]
    w_rew = w_ins[exists]
    fresh_keys = ins_keys[~exists]
    w_fresh = w_ins[~exists]
    if not weighted:
        reweights = reweights[:0]
        w_rew = w_rew[:0]

    n_changed = len(fresh_keys) + len(del_keys) + len(reweights)
    if n_changed == 0:
        return prepared                      # nothing to do: same epoch

    # merged (ordered-id) edge set + aligned weights, ascending key order
    keep = np.ones(len(old_keys), dtype=bool)
    if len(del_keys):
        keep[np.searchsorted(old_keys, del_keys)] = False
    new_keys = np.concatenate([old_keys[keep], fresh_keys])
    order = np.argsort(new_keys, kind="stable")
    new_keys = new_keys[order]
    w_new = None
    if weighted:
        w_old = prepared.weights.copy()
        if len(reweights):
            w_old[np.searchsorted(old_keys, reweights)] = w_rew
        w_new = np.concatenate([w_old[keep], w_fresh])[order]
    g_ord2 = from_edges(n, new_keys // n, new_keys % n,
                        dedup=True, drop_loops=False)

    opts = prepared.options if prepared.options is not None \
        else PrepareOptions()
    budget = staleness_budget if staleness_budget is not None \
        else max(1, int(STALENESS_FRACTION * max(g_ord2.m, 1)))
    stale = prepared.stale_edges + n_changed
    structural = _structural_reason(prepared, fresh_keys, del_keys, g_ord2)

    if stale > budget:
        return _reprepare(prepared, g_ord2, w_new, opts, n_changed,
                          len(fresh_keys), len(del_keys), len(reweights),
                          reason=f"staleness ledger {stale} edges over "
                                 f"budget {budget}")
    if structural is not None or (prepared.problem is not None
                                  and prepared.problem.is_2d):
        reason = structural if structural is not None else \
            "2-D partition relabels columns; no local patch path"
        return _rebuild(prepared, g_ord2, w_new, opts, stale,
                        len(fresh_keys), len(del_keys), len(reweights),
                        reason=reason)
    return _patch(prepared, g_ord2, w_new, opts, stale,
                  fresh_keys, del_keys, reweights)


def _touched_sets(fresh_keys: np.ndarray, del_keys: np.ndarray, n: int,
                  sigma: int) -> np.ndarray:
    """Slice sets whose layout the STRUCTURAL updates perturb (reweights
    touch only the weight plane, never the masks)."""
    srcs = np.concatenate([fresh_keys // n, del_keys // n])
    return np.unique(srcs // sigma).astype(np.int64)


def _structural_reason(prepared: PreparedBFS, fresh_keys, del_keys,
                       g_ord2: Graph) -> str | None:
    """None when every touched set keeps its VSS count (globally AND per
    shard) — the precondition for the bit-identical local patch.  The
    per-shard check reads every shard's offsets, not this rank's block,
    so every rank of a mesh returns the same answer."""
    b = prepared.bvss
    sigma, tau, n = b.sigma, b.tau, b.n
    sets = _touched_sets(fresh_keys, del_keys, n, sigma)
    if not len(sets):
        return None
    # set sizes after the update, from the merged graph's in-CSR
    t_indptr, t_indices = g_ord2.t_csr
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(t_indptr))
    cols = t_indices.astype(np.int64)
    for I in sets:
        in_set = (cols // sigma) == I
        count = len(np.unique(rows[in_set]))
        span = int(b.real_ptrs[I + 1] - b.real_ptrs[I])
        if -(-count // tau) != span:
            return (f"slice set {int(I)} needs {-(-count // tau)} VSSs "
                    f"(has {span}) — realPtrs would shift")
    pb = prepared.problem
    if pb is not None and pb.mesh is not None and not pb.is_2d:
        ptrs = pb.shard_ptrs
        rps = pb.rows_per_shard
        for d in range(pb.n_shards):
            lo, hi = d * rps, min((d + 1) * rps, n)
            local = (rows >= lo) & (rows < hi)
            for I in sets:
                in_set = local & ((cols // sigma) == I)
                count = len(np.unique(rows[in_set]))
                span = int(ptrs[d, I + 1] - ptrs[d, I])
                if -(-count // tau) != span:
                    return (f"shard {d} slice set {int(I)} needs "
                            f"{-(-count // tau)} VSSs (has {span})")
    return None


def _edges_of_sets(g_ord2: Graph, sets: np.ndarray, sigma: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) of every post-update edge whose source lands in one of
    the touched sets (the slices those sets must now encode)."""
    src = src_of_edges(g_ord2).astype(np.int64)
    dst = g_ord2.indices.astype(np.int64)
    mask = np.isin(src // sigma, sets)
    return src[mask], dst[mask]


def _replace_rows(t: torch.Tensor, idx: np.ndarray,
                  rows: np.ndarray) -> torch.Tensor:
    """A NEW tensor equal to ``t`` but for rows ``idx``, which take
    ``rows``; ``t`` itself is never written (epoch isolation)."""
    out = t.clone()
    out.index_copy_(0, torch.from_numpy(idx).to(t.device),
                    torch.from_numpy(np.ascontiguousarray(rows)).to(t.device))
    return out


def _patch(prepared: PreparedBFS, g_ord2: Graph, w_new, opts: PrepareOptions,
           stale: int, fresh_keys, del_keys, reweights) -> PreparedBFS:
    """The cheap path: rewrite only the touched sets' VSS rows, host and
    device, into new arrays and tensors, leaving every buffer of the old
    epoch alone."""
    b = prepared.bvss
    n, sigma = b.n, b.sigma
    sets = _touched_sets(fresh_keys, del_keys, n, sigma)
    # reweighted edges touch their sets' weight-plane rows only
    wsets = np.unique(reweights // n // sigma).astype(np.int64) \
        if len(reweights) else np.zeros(0, dtype=np.int64)
    src_t, dst_t = _edges_of_sets(
        g_ord2, np.union1d(sets, wsets), sigma)

    weight_of = None
    if w_new is not None:
        keys2 = src_of_edges(g_ord2).astype(np.int64) * n \
            + g_ord2.indices.astype(np.int64)

        def weight_of(s: int, d: int) -> float:
            return float(w_new[np.searchsorted(keys2, s * n + d)])

    # ---- host BVSS: per-set re-layout ----
    masks2 = b.masks.copy()
    row_ids2 = b.row_ids.copy()
    rows_rewritten = 0
    for I in sets:
        p0, p1 = int(b.real_ptrs[I]), int(b.real_ptrs[I + 1])
        in_set = (src_t // sigma) == I
        slices: dict[int, int] = {}
        for s, d in zip(src_t[in_set], dst_t[in_set]):
            bit = int(s % sigma)
            slices[int(d)] = slices.get(int(d), 0) | (1 << bit)
        m, r = _encode_set(slices, p1 - p0, sigma, dummy_row=n)
        masks2[p0:p1] = m
        row_ids2[p0:p1] = r
        rows_rewritten += p1 - p0
    num_slices2 = b.num_slices
    for I in sets:
        in_set = (src_t // sigma) == I
        num_slices2 += len(np.unique(dst_t[in_set])) \
            - len(_decode_set(b.masks[b.real_ptrs[I]:b.real_ptrs[I + 1]],
                              b.row_ids[b.real_ptrs[I]:b.real_ptrs[I + 1]],
                              sigma, dummy_row=n))
    bvss2 = dataclasses.replace(b, m=g_ord2.m, num_slices=num_slices2,
                                masks=masks2, row_ids=row_ids2)

    # ---- device problem + weight plane: the touched VSS rows, in new
    # tensors (the old epoch's stay as they were) ----
    pb = prepared.problem
    problem2 = pb
    wplane2 = prepared.wplane
    all_sets = np.union1d(sets, wsets)
    if pb is not None and pb.mesh is not None:
        problem2, wplane2 = _patch_sharded(pb, prepared.wplane, b, all_sets,
                                           g_ord2, weight_of)
    elif pb is not None:
        idx = np.concatenate([np.arange(int(b.real_ptrs[I]),
                                        int(b.real_ptrs[I + 1]))
                              for I in sets]) if len(sets) else \
            np.zeros(0, dtype=np.int64)
        dev = pb.dev
        if len(idx):
            # the device masks are the int32 carriers of the uint32 words
            dev = dev._replace(
                masks=_replace_rows(dev.masks, idx,
                                    masks2[idx].view(np.int32)),
                row_ids=_replace_rows(dev.row_ids, idx, row_ids2[idx]))
        problem2 = dataclasses.replace(pb, dev=dev)
    if prepared.wplane is not None and (pb is None or pb.mesh is None):
        # the plane exists even without a device problem (non-BVSS
        # engine, weighted prep) — patch it in either case
        wplane2 = _patch_wplane(prepared.wplane, b, all_sets, g_ord2,
                                weight_of)

    report = UpdateReport(
        path="patched", epoch=prepared.epoch + 1,
        n_inserted=len(fresh_keys), n_deleted=len(del_keys),
        n_reweighted=len(reweights), sets_touched=len(sets) + len(
            np.setdiff1d(wsets, sets)),
        vss_rows_rewritten=rows_rewritten, stale_edges=stale)
    return _finish(prepared, g_ord2, bvss2, problem2, w_new, wplane2, opts,
                   report)


def _patch_wplane(wplane: torch.Tensor, b: BVSS, sets, g_ord2: Graph,
                  weight_of) -> torch.Tensor:
    """Recomputed weight-plane rows for the touched sets, in a new plane
    ((num_vss + 1, spw, LANES, σ), +inf dummy last)."""
    n, sigma = b.n, b.sigma
    src_t, dst_t = _edges_of_sets(g_ord2, sets, sigma)
    idx, rows = [], []
    for I in sets:
        p0, p1 = int(b.real_ptrs[I]), int(b.real_ptrs[I + 1])
        in_set = (src_t // sigma) == I
        slices: dict[int, int] = {}
        for s, d in zip(src_t[in_set], dst_t[in_set]):
            slices[int(d)] = slices.get(int(d), 0) | (1 << int(s % sigma))
        idx.append(np.arange(p0, p1))
        rows.append(_weight_rows(slices, p1 - p0, sigma, int(I), weight_of))
    if not idx:
        return wplane
    return _replace_rows(wplane, np.concatenate(idx), np.concatenate(rows))


def _patch_sharded(pb: BlestProblem, wplane, b: BVSS, sets, g_ord2: Graph,
                   weight_of) -> tuple[BlestProblem, torch.Tensor | None]:
    """1-D row-sharded patch of THIS rank's block: per touched set,
    re-layout against the shard's own VSS range (``pb.shard_ptrs``), rows
    in LOCAL ids (dummy = rows_per_shard), weight-plane rows through
    ``w_local``; in new tensors, as on one device."""
    n, sigma = b.n, b.sigma
    d = pb.mesh.get_local_rank(pb.axis)
    rps = pb.rows_per_shard
    lo, hi = d * rps, min((d + 1) * rps, n)
    src_t, dst_t = _edges_of_sets(g_ord2, sets, sigma)
    local = (dst_t >= lo) & (dst_t < hi)

    def w_local(src_global: int, row_local: int) -> float:
        return weight_of(src_global, row_local + lo)

    idx, masks, row_ids, planes = [], [], [], []
    for I in sets:
        p0, p1 = int(pb.shard_ptrs[d, I]), int(pb.shard_ptrs[d, I + 1])
        in_set = local & ((src_t // sigma) == I)
        slices: dict[int, int] = {}
        for s, dd in zip(src_t[in_set], dst_t[in_set]):
            row = int(dd - lo)
            slices[row] = slices.get(row, 0) | (1 << int(s % sigma))
        m, r = _encode_set(slices, p1 - p0, sigma, dummy_row=rps)
        idx.append(np.arange(p0, p1))
        masks.append(m)
        row_ids.append(r)
        if wplane is not None:
            planes.append(_weight_rows(slices, p1 - p0, sigma, int(I),
                                       w_local))
    dev = pb.dev
    at = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    if len(at):
        dev = dev._replace(
            masks=_replace_rows(dev.masks, at,
                                np.concatenate(masks).view(np.int32)),
            row_ids=_replace_rows(dev.row_ids, at, np.concatenate(row_ids)))
        if wplane is not None:
            wplane = _replace_rows(wplane, at, np.concatenate(planes))
    return dataclasses.replace(pb, dev=dev), wplane


def _rebuild(prepared: PreparedBFS, g_ord2: Graph, w_new,
             opts: PrepareOptions, stale: int, n_ins: int, n_del: int,
             n_rew: int, *, reason: str) -> PreparedBFS:
    """Structural fallback: fresh BVSS/problem/plane over the SAME
    ordering (perm/inv/caller contract unchanged), on the prepared
    device; on a mesh the sharded problem (1-D with its sharded weight
    plane, or 2-D), each rank keeping its own block."""
    sigma = prepared.bvss.sigma
    device = prepared.device
    mesh = prepared.mesh
    bvss2 = build_bvss(g_ord2, sigma=sigma)
    wplane2 = None
    if mesh is not None and w_new is not None:
        # weights need a 1-D mesh (prepare refuses them on 2-D)
        sb = build_sharded_bvss(g_ord2, axis_size(mesh, opts.mesh_axis),
                                sigma=sigma)
        problem2 = BlestProblem.build_sharded(sb, mesh, opts.mesh_axis,
                                              device)
        wplane2 = weight_plane_to_device(
            build_sharded_weight_plane(g_ord2, w_new, sb), device,
            mesh=mesh, axis=opts.mesh_axis)
    elif mesh is not None:
        problem2 = build_problem(g_ord2, sigma=sigma, mesh=mesh,
                                 mesh_axis=opts.mesh_axis, device=device)
    else:
        problem2 = BlestProblem.build(bvss2, device) \
            if prepared.engine_name in BVSS_ENGINES else None
        if w_new is not None:
            wplane2 = weight_plane_to_device(
                build_weight_plane(g_ord2, w_new, sigma=sigma), device)
    report = UpdateReport(
        path="rebuilt", epoch=prepared.epoch + 1, n_inserted=n_ins,
        n_deleted=n_del, n_reweighted=n_rew, sets_touched=bvss2.n_sets,
        vss_rows_rewritten=bvss2.num_vss, stale_edges=stale, reason=reason)
    return _finish(prepared, g_ord2, bvss2, problem2, w_new, wplane2, opts,
                   report)


def _reprepare(prepared: PreparedBFS, g_ord2: Graph, w_new,
               opts: PrepareOptions, n_changed: int, n_ins: int, n_del: int,
               n_rew: int, *, reason: str) -> PreparedBFS:
    """Staleness fallback: reconstruct the ORIGINAL graph in caller ids
    and re-run the whole static pipeline (new ordering, fresh ledger)."""
    n = g_ord2.n
    inv = prepared.inv
    src_o = inv[src_of_edges(g_ord2).astype(np.int64)]
    dst_o = inv[g_ord2.indices.astype(np.int64)]
    g_orig = from_edges(n, src_o, dst_o, dedup=True, drop_loops=False)
    w_orig = None
    if w_new is not None:
        # caller-order weights: original CSR sorts ascending by caller key
        w_orig = w_new[np.argsort(src_o * n + dst_o, kind="stable")]
    fresh = prepare(g_orig, options=opts.replace(weights=w_orig))
    report = UpdateReport(
        path="reprepared", epoch=prepared.epoch + 1, n_inserted=n_ins,
        n_deleted=n_del, n_reweighted=n_rew,
        sets_touched=fresh.bvss.n_sets,
        vss_rows_rewritten=fresh.bvss.num_vss, stale_edges=0, reason=reason)
    return dataclasses.replace(fresh, epoch=prepared.epoch + 1,
                               stale_edges=0, last_update=report)


def _finish(prepared: PreparedBFS, g_ord2: Graph, bvss2: BVSS, problem2,
            w_new, wplane2, opts: PrepareOptions,
            report: UpdateReport) -> PreparedBFS:
    """Rebuild the engine on the next-epoch structures, on the prepared
    device and with the tuned knobs, and assemble the result.  The tuned
    ladder is rebuilt for the new VSS count (a rebuild can grow it past
    the old top rung, the queue's capacity; the reference re-injects the
    old ladder)."""
    tile_config = None if prepared.tile_config is None else \
        prepared.tile_config.fit(bvss2.num_vss)
    tuned = tile_config.engine_kwargs() if tile_config is not None else {}
    fn = make_engine(g_ord2, prepared.engine_name, bvss=bvss2,
                     problem=problem2, device=prepared.device,
                     use_kernels=opts.use_kernels, buckets=opts.buckets,
                     direction=opts.direction, push_impl=opts.push_impl,
                     **tuned)
    return dataclasses.replace(
        prepared, graph=g_ord2, bvss=bvss2, problem=problem2,
        update_divergence=bvss2.update_divergence(), weights=w_new,
        wplane=wplane2 if w_new is not None else prepared.wplane,
        tile_config=tile_config, epoch=prepared.epoch + 1,
        stale_edges=report.stale_edges, last_update=report, _fn=fn)
