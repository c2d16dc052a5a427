"""Multi-source BFS as batched BVSS bit-SpMM (paper §2 + §7, DESIGN §2.5) —
the single-device half of ``repro/core/multi_source.py``.

Stacking S frontiers column-wise turns the SpMSpV pull into an SpMM: the
slices of every queued VSS are contracted against the S stacked σ-bit
frontier bytes of its slice set (CUDA ``bvss_spmm``).  One compacted
*union* queue of VSSs serves all columns (a slice set is live if ANY
column's frontier touches it); the per-column frontier is kept as packed
words ``(n_fwords, S)``.

:func:`make_ms_engine` exposes the building blocks (init / insert /
requeue / one lock-step level) that the wave-serving loop
:func:`drive_wave` drives with mid-flight slot refills, and
:func:`make_multi_source_bfs` runs the whole loop for a fixed cohort
(closeness, eccentricity).

What changes from the reference is where the control lives, as in
``core/bfs.py``: the reference's ``lax.while_loop`` becomes a host loop,
and its two ``lax.cond``s (the queue-width ladder and the push/pull
choice) become host decisions.  :func:`make_ms_engine`'s ``requeue`` —
the end of every level, of ``init`` and of every refill round — ends in
ONE device-to-host copy that brings back everything the host decides
with: the live VSS count, the per-column liveness and, when the engine
can push, the direction scalars (union-frontier popcount, total frontier
bits, unvisited entries).  Each engine counts its host copies in
``stats["host_syncs"]``, and its pull and push levels.

Device state is updated in place (the reference returns new arrays); a
state must not be used again after it was passed to ``insert``,
``insert_batch``, ``step`` or ``level_step``.  The reference's eager
scatter-min (``levels.at[rows].min(col_lvl + 1)``) becomes the lazy
scheme of Alg. 3, per column: the step stores 1 into a uint8 mark of
every hit ``(row, column)`` cell with one indexed store (every writer of
a cell stores the same value, so no atomics; misses go to the dummy row
``n``), and ``finalize`` gives level ``col_lvl + 1`` to the marked cells
still at INF.  A visited row already holds a level no larger than its
column's depth, so this equals the min.  The eager form's check of each
hit row's level needs a gather of ``w·τ`` rows of ``levels``, which cost
more than the rest of a grid level together on the H100 (PERF.md).

Not in this slice: the σ path-count channel (``track_sigma``, which needs
the ``bvss_spmm_w`` kernel of the betweenness slice) and the mesh paths.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.bfs import (DIRECTIONS, BlestProblem, INF,
                                  _frontier_bytes, _make_popcount,
                                  _round_width, expand_push_queue,
                                  make_compactor, make_vertex_compactor,
                                  queue_widths, resolve_push_cap,
                                  select_width, selected_width)
from repro_torch.core.level_pipeline import LevelPipeline, run_levels
from repro_torch.errors import ConfigError
from repro_torch.graphs import Graph
from repro_torch.kernels import bvss_spmm
from repro_torch.kernels.ref import bvss_spmm_ref, pack_words


def _union_words(F: torch.Tensor) -> torch.Tensor:
    """OR the per-column packed frontiers ``(n_fwords, S)`` into one union
    word array ``(n_fwords,)`` — the push phase compacts its vertex queue
    from this.  PyTorch has no OR reduction, so columns are OR-ed in
    halves, ``ceil(log2 S)`` ops."""
    while F.shape[1] > 1:
        c, h = F.shape[1], (F.shape[1] + 1) // 2
        paired = F[:, :c - h] | F[:, h:]
        F = paired if c == 2 * h else torch.cat([paired, F[:, c - h:h]], 1)
    return F[:, 0]


def _push_fbytes(F: torch.Tensor, vrep: torch.Tensor, sigma: int
                 ) -> torch.Tensor:
    """Per-(queue entry, column) one-hot frontier bytes for the batched
    push phase: entry b pushing vertex v contributes ``1 << (v % σ)`` to
    exactly the columns whose frontier holds v, 0 elsewhere.  The dummy
    vertex n may lie past the last frontier word; its gather is clamped
    (as JAX clamps it), and whatever byte it gives meets the all-zero
    masks of the dummy VSS."""
    word = F[(vrep >> 5).clamp_max(F.shape[0] - 1)]            # (B, S)
    member = (word >> (vrep & 31).to(torch.int32)[:, None]) & 1
    one_hot = torch.ones_like(vrep) << (vrep % sigma)          # int64
    return (one_hot[:, None] * member).to(torch.int32)


def _pack_cols(bits: torch.Tensor, lwords: int) -> torch.Tensor:
    """Per-column frontier pack: bool (lwords*32, S) -> int32 (lwords, S)."""
    return pack_words(bits.reshape(lwords * 32, -1))


def _unpack_cols(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_cols`: int32 (lwords, S) -> bool
    (lwords*32, S)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return (((words[:, None, :] >> shifts[None, :, None]) & 1)
            .reshape(-1, words.shape[1]) != 0)


def _host_array(x, dtype) -> np.ndarray:
    """A host NumPy copy of an index/mask argument (tensor or array-like)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _index_tensor(x, device: torch.device) -> torch.Tensor:
    """Host indices as an int64 tensor on ``device``.  The copy does not
    block: a blocking host-to-device copy would synchronise the stream."""
    return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(
        device, non_blocking=True)


class MSState(NamedTuple):
    levels: torch.Tensor  # (n+1, S) int32; row n is the dummy row
    marks: torch.Tensor   # (n+1, S) uint8 hit marks of the running level
                          #   (all 0 between levels); row n is the sink
    F: torch.Tensor       # (n_fwords, S) int32 per-column packed frontier
    Q: torch.Tensor       # (qcap,) int64 union VSS queue, dummy-padded
    count: int            # live VSS count (host copy: the bucket pick)
    col_lvl: torch.Tensor  # (S,) int32 per-column BFS depth reached so far
    cont: bool            # any live VSS (host copy)
    live: np.ndarray      # (S,) bool per-column frontier non-empty (host)
    # host copies of the auto direction test's inputs (0 when the engine
    # cannot push): popcount of the union frontier, of all frontier bits,
    # and the number of unvisited (vertex, column) entries
    ucount: int = 0
    tbits: int = 0
    unvisited: int = 0


@dataclasses.dataclass(frozen=True)
class MSEngine:
    """Building blocks of the batched BVSS SpMM level step.

    ``step``/``finalize`` plug into :class:`LevelPipeline` for the fixed
    cohort loop; ``insert``/``requeue``/``level_step``/``col_live`` are the
    wave-serving surface, driven by the host between levels.
    ``levels_of(state, slot)`` gives one column's ``(n,)`` levels (a list
    of slots gives ``(n, k)``), on the device."""

    problem: BlestProblem
    n_slots: int
    init: Callable        # (sources (S,)) -> MSState, queue rebuilt
    idle: Callable        # () -> MSState with no live columns
    insert: Callable      # (state, slot, src) -> MSState (requeue after!)
    insert_batch: Callable  # (state, srcs (S,), mask (S,)) -> MSState with
                          # every masked slot reset + queue rebuilt: one
                          # host copy per refill round (the drive_wave path)
    requeue: Callable     # (state) -> state with Q/count rebuilt from F
    step: Callable        # (state) -> state after gather+pull+update
    finalize: Callable    # (state) -> state after pack+requeue
    level_step: Callable  # (state) -> (state, live (S,) bool host array)
                          # after one full level: liveness rides the
                          # level's one host copy
    col_live: Callable    # (state) -> (S,) bool host array, frontier
                          # non-empty (read from the device)
    levels_of: Callable   # (state, slot or slots) -> levels on the device
    stats: dict           # host copies, pull levels and push levels run


def make_ms_engine(problem: BlestProblem, n_slots: int, *,
                   use_kernel: bool = True, buckets: int = 2,
                   track_sigma: bool = False,
                   widths: list[int] | None = None,
                   direction: str = "auto", push_cap: int | None = None,
                   alpha: float = 4.0,
                   spmm_impl: Callable | None = None,
                   spmm_w_impl: Callable | None = None,
                   gather_impl: Callable | None = None,
                   push_impl: Callable | None = None) -> MSEngine:
    """Build the S-column lock-step BVSS level machinery.

    ``direction`` / ``push_cap`` / ``alpha`` / ``widths`` are the
    direction-optimizing knobs of DESIGN §2.8, batched: the push branch
    compacts the UNION frontier (any column) into a vertex queue, expands
    each vertex into the ≤ R VSSs of its own slice set, and pushes
    per-column one-hot frontier bytes through the SAME bit-SpMM kernel the
    pull uses, so both directions share one kernel and one seam
    (``spmm_impl``).  ``widths`` overrides the bucketed pull ladder.

    ``track_sigma=True`` is a :class:`~repro_torch.errors.ConfigError`:
    the σ channel needs the ``bvss_spmm_w`` kernel of the betweenness
    slice.  As in the reference, ``spmm_w_impl`` (used only by the σ
    channel), ``gather_impl`` (consulted only on a sharded problem) and
    ``push_impl`` (the wave push rides the spmm seam) are accepted and
    ignored here."""
    del spmm_w_impl, gather_impl, push_impl
    p = problem
    if direction not in DIRECTIONS:
        raise ConfigError(
            f"direction must be one of {DIRECTIONS}, got {direction!r}")
    if track_sigma:
        raise ConfigError(
            "track_sigma (the Brandes σ path-count channel) is not ported to "
            "PyTorch yet: it needs the bvss_spmm_w kernel, which comes with "
            "the betweenness slice (ROADMAP.md queue 1 item 6)")
    spmm = spmm_impl if spmm_impl is not None else \
        (bvss_spmm if use_kernel else bvss_spmm_ref)
    dev = p.dev
    device = p.device
    sigma = p.sigma
    S = n_slots
    n, n_fwords = p.n, p.n_fwords
    widths = list(widths) if widths is not None else \
        queue_widths(p.num_vss, buckets)
    qcap = widths[-1]
    compact = make_compactor(dev, p.num_vss, qcap)
    popcount = _make_popcount(device)
    all_sets = torch.arange(p.n_sets, dtype=torch.int32, device=device)
    cols = torch.arange(S, dtype=torch.int64, device=device)
    one = torch.ones((), dtype=torch.uint8, device=device)
    stats = {"host_syncs": 0, "pull_levels": 0, "push_levels": 0}

    def mark(state: MSState, ids: torch.Tensor,
             counts: torch.Tensor) -> MSState:
        """marks[rows[e], s] = 1 wherever ``counts[e, s] > 0``, misses to
        the dummy row, as one indexed store (module docstring); the row
        indices stay int32."""
        rows = dev.row_ids[ids].reshape(-1)                     # (E,) int32
        hit = counts.view(rows.shape[0], S) > 0
        tgt = torch.where(hit, rows[:, None], n)               # (E, S) int32
        state.marks.index_put_((tgt, cols), one)
        return state

    def pull_update(state: MSState, width: int) -> MSState:
        ids = state.Q[:width]
        fb = _frontier_bytes(state.F, dev.virtual_to_real[ids], sigma)
        counts = spmm(dev.masks[ids], fb, sigma=sigma)  # (w, spw, 32, S)
        stats["pull_levels"] += 1
        return mark(state, ids, counts)

    def pull_step(state: MSState) -> MSState:
        return select_width(widths, state.count,
                            lambda w: pull_update(state, w))

    pcap = resolve_push_cap(direction, push_cap, n)
    pqcap = _round_width(pcap)
    R = p.max_vss_per_set
    push_cost = pqcap * R
    can_push = direction == "push" or (direction == "auto"
                                       and push_cost < widths[-1])
    if not can_push:
        # push can never undercut even the full pull width: the pure pull
        # step (the same static bail as the single-source engines)
        step = pull_step
    else:
        compact_vertices = make_vertex_compactor(n_fwords, n, pqcap, device)

        def push_update(state: MSState) -> MSState:
            """Batched push level (DESIGN §2.8): union-frontier vertex
            queue → per-vertex VSS expansion → per-column one-hot bytes
            through the same bit-SpMM kernel → the same marks."""
            VQ, _ = compact_vertices(_union_words(state.F))
            ids = expand_push_queue(dev, VQ, R, p.num_vss)
            vrep = VQ[:, None].expand(pqcap, R).reshape(-1)
            fb = _push_fbytes(state.F, vrep, sigma)
            counts = spmm(dev.masks[ids], fb, sigma=sigma)
            stats["push_levels"] += 1
            return mark(state, ids, counts)

        if direction == "push":
            step = push_update
        else:
            def step(state: MSState) -> MSState:
                use_push = (state.ucount <= pcap
                            and push_cost < selected_width(widths,
                                                           state.count)
                            and np.float32(state.tbits) * np.float32(alpha)
                            <= np.float32(state.unvisited))
                return push_update(state) if use_push else pull_step(state)

    def requeue(state: MSState) -> MSState:
        """Rebuild the union queue from the per-column frontiers (a slice
        set is live iff any column's σ-bit frontier byte is non-zero) and
        bring the level's host scalars back in one copy."""
        set_active = (_frontier_bytes(state.F, all_sets, sigma) != 0
                      ).any(dim=1)
        Q, count = compact(set_active)
        live = (state.F != 0).any(dim=0)
        scalars = [count.view(1), live.to(torch.int64)]
        if can_push:
            scalars += [popcount(_union_words(state.F)).view(1),
                        popcount(state.F).view(1),
                        (state.levels[:n] == INF).sum().view(1)]
        host = torch.cat(scalars).tolist()
        stats["host_syncs"] += 1
        count = int(host[0])
        extra = host[1 + S:] if can_push else [0, 0, 0]
        return state._replace(Q=Q, count=count, cont=count > 0,
                              live=np.array(host[1:1 + S], dtype=bool),
                              ucount=extra[0], tbits=extra[1],
                              unvisited=extra[2])

    def finalize(state: MSState) -> MSState:
        lv = state.levels[:n]
        new = (state.marks[:n] != 0) & (lv == INF)              # (n, S)
        lv.copy_(torch.where(new, (state.col_lvl + 1)[None, :], lv))
        state.marks.zero_()
        bits = torch.zeros((n_fwords * 32, S), dtype=torch.bool,
                           device=device)
        bits[:n] = new
        state = state._replace(F=_pack_cols(bits, n_fwords),
                               col_lvl=state.col_lvl + new.any(dim=0))
        return requeue(state)

    def fresh_state() -> MSState:
        return MSState(
            levels=torch.full((n + 1, S), INF, dtype=torch.int32,
                              device=device),
            marks=torch.zeros((n + 1, S), dtype=torch.uint8, device=device),
            F=torch.zeros((n_fwords, S), dtype=torch.int32, device=device),
            Q=torch.full((qcap,), p.num_vss, dtype=torch.int64,
                         device=device),
            count=0, col_lvl=torch.zeros((S,), dtype=torch.int32,
                                         device=device),
            cont=False, live=np.zeros(S, dtype=bool), unvisited=n * S)

    def seed(state: MSState, srcs: np.ndarray, slots: np.ndarray) -> None:
        """Level 0 of fresh queries ``srcs`` in columns ``slots`` (whose
        levels and frontier words are already cleared), in place."""
        sv, sl = _index_tensor(np.stack([srcs, slots]), device)
        state.levels[sv, sl] = 0
        state.F[sv >> 5, sl] = (torch.ones_like(sv) << (sv & 31)).to(
            torch.int32)

    def init(sources) -> MSState:
        srcs = _host_array(sources, np.int64)
        if srcs.shape != (S,):
            raise ConfigError(
                f"init needs {S} sources (one per slot), got shape "
                f"{srcs.shape}")
        st = fresh_state()
        seed(st, srcs, np.arange(S))
        return requeue(st)

    def insert(state: MSState, slot: int, src: int) -> MSState:
        """Reset column ``slot`` to a fresh query from ``src`` (internal
        ids), in place.  Call ``requeue`` once after a refill round."""
        slot = int(slot)
        state.levels[:, slot] = INF
        state.F[:, slot] = 0
        state.col_lvl[slot] = 0
        seed(state, np.array([int(src)]), np.array([slot]))
        return state

    def insert_batch(state: MSState, srcs, mask) -> MSState:
        """Reset every slot with ``mask[j]`` to a fresh query from
        ``srcs[j]`` and rebuild the queue (``srcs[j]`` is ignored where the
        mask is False)."""
        slots = np.flatnonzero(_host_array(mask, bool))
        if len(slots):
            sl = _index_tensor(slots, device)
            state.levels.index_fill_(1, sl, INF)
            state.F.index_fill_(1, sl, 0)
            state.col_lvl.index_fill_(0, sl, 0)
            seed(state, _host_array(srcs, np.int64)[slots], slots)
        return requeue(state)

    def level_step(state: MSState) -> tuple[MSState, np.ndarray]:
        state = finalize(step(state))
        return state, state.live

    def col_live(state: MSState) -> np.ndarray:
        stats["host_syncs"] += 1
        return (state.F != 0).any(dim=0).cpu().numpy()

    def levels_of(state: MSState, slot) -> torch.Tensor:
        if isinstance(slot, (int, np.integer)):
            return state.levels[:n, int(slot)]
        return state.levels[:n].index_select(1, _index_tensor(slot, device))

    return MSEngine(
        problem=p, n_slots=S, init=init, idle=fresh_state, insert=insert,
        insert_batch=insert_batch, requeue=requeue, step=step,
        finalize=finalize, level_step=level_step, col_live=col_live,
        levels_of=levels_of, stats=stats)


# ---------------------------------------------------------------------------
# generic wave driver: the ONE slot-pool serving loop (DESIGN §2.5/§2.6)
# ---------------------------------------------------------------------------
def drive_wave(eng: MSEngine,
               next_source: Callable[[int], int | None],
               on_converged: Callable[[int, np.ndarray], None], *,
               max_steps: int | None = None,
               should_harvest: Callable[[int], bool] | None = None,
               on_harvested: Callable[[int, np.ndarray], None] | None = None
               ) -> int:
    """Drive batched waves with mid-flight slot refills until the refill
    hook runs dry — the host loop shared by level serving
    (``GraphSession.levels_batch``) and flood-fill re-seeding
    (``repro_torch.analytics.components``).

    ``next_source(slot)`` returns the next source (internal row id) to
    launch in a freed slot, or None when the caller has nothing to queue
    *right now* (it is asked again after every harvest).
    ``on_converged(slot, levels)`` receives each converged column's
    ``(n,)`` host level array.  Returns the number of lock-step levels run.

    ``should_harvest(slot)`` / ``on_harvested(slot, levels)`` are the
    cancellation hooks (DESIGN §2.7): after every lock-step level, each
    still-live slot is offered to ``should_harvest``; answering True
    harvests the column mid-flight — ``on_harvested`` receives the PARTIAL
    levels computed so far (unreached vertices are ``INF``) and the slot is
    freed for refill on the next round.

    One difference of mechanism from the reference: the columns that
    converge or are harvested in one level come back to the host in ONE
    copy, so every slot's ``should_harvest`` is asked before that level's
    ``on_converged``/``on_harvested`` calls are made (in slot order).
    """
    S = eng.n_slots
    busy = [False] * S
    st = eng.idle()
    steps = 0
    srcs = np.zeros(S, dtype=np.int64)
    mask = np.zeros(S, dtype=bool)
    while True:
        mask[:] = False
        for slot in range(S):
            if not busy[slot]:
                src = next_source(slot)
                if src is None:
                    continue
                srcs[slot] = int(src)
                mask[slot] = True
                busy[slot] = True
        if not any(busy):
            return steps
        if mask.any():  # one insert + requeue (one host copy) per round
            st = eng.insert_batch(st, srcs, mask)
        st, live = eng.level_step(st)
        done: list[tuple[int, Callable | None]] = []
        for slot in range(S):
            if not busy[slot]:
                continue
            if not live[slot]:
                done.append((slot, on_converged))
                busy[slot] = False
            elif should_harvest is not None and should_harvest(slot):
                # harvest mid-flight: the stale column is overwritten by
                # the next insert_batch (until then its frontier bits cost
                # only the union queue a few extra live sets)
                done.append((slot, on_harvested))
                busy[slot] = False
        if done:
            host = eng.levels_of(st, [s for s, _ in done]).cpu().numpy()
            eng.stats["host_syncs"] += 1
            for i, (slot, callback) in enumerate(done):
                if callback is not None:
                    callback(slot, np.ascontiguousarray(host[:, i]))
        steps += 1
        if max_steps is not None and steps > max_steps:
            raise RuntimeError(
                f"wave serving did not converge in {max_steps} level steps")


def make_multi_source_bfs(g: Graph | None, n_sources: int, *,
                          use_kernel: bool = True,
                          max_levels: int | None = None,
                          bvss=None, problem: BlestProblem | None = None,
                          buckets: int = 2,
                          widths: list[int] | None = None,
                          direction: str = "auto",
                          push_cap: int | None = None,
                          alpha: float = 4.0,
                          device: "str | torch.device | None" = None
                          ) -> Callable:
    """Build ``f(sources (S,)) -> levels (n, S) int32 tensor`` running the
    whole level loop for a fixed source cohort (one host copy per level).
    Without ``problem``, one is built from ``bvss`` (or from ``g``) on
    ``device`` (default: the card).  ``widths`` / ``direction`` /
    ``push_cap`` / ``alpha`` are the direction-optimizing knobs (DESIGN
    §2.8; see :func:`make_ms_engine`)."""
    if problem is None:
        if bvss is None:
            from repro_torch.core.bvss import build_bvss
            bvss = build_bvss(g)
        problem = BlestProblem.build(bvss, device)
    max_lv = max_levels if max_levels is not None else problem.n + 1
    eng = make_ms_engine(problem, n_sources, use_kernel=use_kernel,
                         buckets=buckets, widths=widths,
                         direction=direction, push_cap=push_cap,
                         alpha=alpha)
    pipe = LevelPipeline(step=lambda s, lvl: eng.step(s),
                         finalize=lambda s, lvl: eng.finalize(s),
                         active=lambda s: s.cont)

    def bfs(sources) -> torch.Tensor:
        state, _ = run_levels(pipe, eng.init(sources), max_levels=max_lv)
        return state.levels[:problem.n]

    bfs.engine = eng
    return bfs
