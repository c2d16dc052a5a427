"""Single-source BLEST engines (paper §4, Algorithms 2 & 3) on PyTorch —
the single-device half of ``repro/core/bfs.py``.

Engines
-------
reference      host NumPy queue BFS (test oracle)
blest          Alg. 2: BVSS queue, frontier-aware blocks, eager scatter-min
blest_lazy     Alg. 3: lazy marks (fire-and-forget) + dense finalise sweep

The level step is the reference's fused, direction-optimizing step
(DESIGN §2.3/§2.8): one batched pull over the compacted VSS queue (CUDA
``bvss_pull``) or, on small frontiers, one push over the frontier
vertices' own VSSs (CUDA ``bvss_push``); one scatter; one fused finalise +
frontier-pack + set-flag sweep (CUDA ``finalize_pack_sweep``) feeding
cumsum compaction.

What changes from the reference is where the control lives.  The
reference keeps the loop, the queue-width ladder (``lax.cond``) and the
push/pull choice (``lax.cond``) on the device.  Here the level loop is a
host loop (:func:`repro_torch.core.level_pipeline.run_levels`) that reads
the level's scalars back once per level, and the host picks the width and
the direction from those scalars with the reference's exact tests.  Each
kernel is then launched at the width the host picked.

Device words are ``torch.int32`` holding uint32 bit patterns; every right
shift is followed by a mask, so sign extension never leaks.  Scatter
indices that must be dropped (the reference's ``mode="drop"``) go to one
extra slot that is sliced off.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.bvss import BVSS, BVSSDevice, build_bvss, to_device
from repro_torch.core.level_pipeline import LevelPipeline, run_levels
from repro_torch.errors import ConfigError
from repro_torch.graphs import Graph
from repro_torch.kernels import (finalize_pack_sweep, pull_vss_kernel,
                                 push_vss_kernel)
from repro_torch.kernels.ref import (bvss_pull_ref, bvss_push_ref,
                                     finalize_pack_ref, pack_words)

INF = np.int32(np.iinfo(np.int32).max)

PULL_TILE = 128  # queue widths are padded to this (the reference's tile)


def _i32(x: int) -> int:
    """A uint32 bit pattern as the int32 value that carries it."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------
def reference_bfs(g: Graph, src: int) -> np.ndarray:
    """NumPy frontier BFS over out-CSR; returns level array (INF = unreached)."""
    levels = np.full(g.n, INF, dtype=np.int32)
    levels[src] = 0
    frontier = np.array([src], dtype=np.int64)
    lvl = 0
    while len(frontier):
        lvl += 1
        nbrs = np.unique(np.concatenate(
            [g.indices[g.indptr[u]:g.indptr[u + 1]] for u in frontier]))
        new = nbrs[levels[nbrs] == INF].astype(np.int64)
        levels[new] = lvl
        frontier = new
    return levels


# ---------------------------------------------------------------------------
# shared device helpers
# ---------------------------------------------------------------------------
def _pack_bits(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """bool (n_words*32,) -> int32 (n_words,), bit i of word w = bits[32w+i]."""
    return pack_words(bits.reshape(n_words * 32))


#: the plain PyTorch pull (the twin path, ``use_kernels=False``)
pull_vss_twin = bvss_pull_ref


def _frontier_bytes(F: torch.Tensor, sets: torch.Tensor, sigma: int
                    ) -> torch.Tensor:
    """Gather the σ-bit frontier word of slice set ids ``sets`` from packed
    F: (n_fwords,) int32 single frontier -> (B,), or (n_fwords, S) stacked
    per-source columns -> (B, S)."""
    bitpos = sets.to(torch.int32) * sigma
    idx = bitpos >> 5
    shift = bitpos & 31
    if F.dim() == 2:
        shift = shift[:, None]
    return (F[idx] >> shift) & _i32((1 << sigma) - 1)


def _make_popcount(device: torch.device) -> Callable:
    """``popcount(words int32) -> int64 0-d tensor``: total set bits, by a
    per-byte table (PyTorch has no popcount op)."""
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64, device=device)

    def popcount(words: torch.Tensor) -> torch.Tensor:
        return table[words.view(torch.uint8).to(torch.int64)].sum()

    return popcount


# ---------------------------------------------------------------------------
# BLEST problem bundle
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlestProblem:
    n: int
    sigma: int
    n_sets: int       # slice sets (columns)
    num_vss: int
    n_fwords: int     # packed frontier words
    dev: BVSSDevice
    # static push expansion factor: every pushing vertex enqueues at most
    # this many VSSs of its own slice set (DESIGN §2.8)
    max_vss_per_set: int = 1

    @property
    def device(self) -> torch.device:
        return self.dev.masks.device

    @staticmethod
    def build(bvss: BVSS, device: "str | torch.device | None" = None
              ) -> "BlestProblem":
        return BlestProblem(n=bvss.n, sigma=bvss.sigma, n_sets=bvss.n_sets,
                            num_vss=bvss.num_vss,
                            n_fwords=bvss.n_frontier_words,
                            dev=to_device(bvss, device),
                            max_vss_per_set=bvss.max_vss_per_set)


PullFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
PushFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

#: direction modes of the hybrid BVSS engines (DESIGN §2.8)
DIRECTIONS = ("auto", "pull", "push")

#: default auto-mode push cap: the largest frontier popcount a push level
#: will take on (also the push vertex-queue width)
DEFAULT_PUSH_CAP = PULL_TILE


class _BlestState(NamedTuple):
    levels: torch.Tensor  # (n + 1,) int32, slot n = dummy row sink
    F: torch.Tensor       # (n_fwords,) int32 packed frontier
    Q: torch.Tensor       # (qcap,) int64 compacted VSS queue, dummy-padded
    count: int            # live VSS count (host copy)
    marks: torch.Tensor   # (n + 1,) uint8 lazy scratch ((1,) when eager)
    unvisited: int        # unvisited-vertex count (host; the Beamer-style
                          #   saturation guard of the direction heuristic)
    fcount: int           # popcount(F) (host copy)
    cont: bool            # continue flag


def _round_width(x: int) -> int:
    return max(PULL_TILE, ((x + PULL_TILE - 1) // PULL_TILE) * PULL_TILE)


def queue_widths(num_vss: int, buckets: int) -> list[int]:
    """Static queue widths, smallest first; the live VSS count picks one
    (DESIGN §2.3/§2.8).

    The ladder is geometric with ratio 8: ``buckets`` graduations
    ``num_vss / 8^(buckets-1), ..., num_vss / 8, num_vss`` rounded up to
    the PULL_TILE floor, deduplicated ascending (the full width is always
    last).  A bucket count < 1 is a :class:`ConfigError`.
    """
    if buckets < 1:
        raise ConfigError(
            f"queue_widths needs buckets >= 1, got {buckets!r}")
    widths: list[int] = []
    for i in range(buckets - 1, -1, -1):
        w = _round_width(-(-num_vss // 8 ** i))
        if not widths or w > widths[-1]:
            widths.append(w)
    return widths


def selected_width(widths: list[int], count: int) -> int:
    """The smallest ladder width holding ``count`` live entries (the full
    width when none does) — also the pull-side term of the direction
    heuristic's work model."""
    for w in widths[:-1]:
        if count <= w:
            return w
    return widths[-1]


def select_width(widths: list[int], count: int, apply: Callable):
    """Run ``apply(width)`` at the width :func:`selected_width` picks — the
    host stand-in for the reference's ``lax.cond`` ladder: the kernel is
    launched at exactly that width."""
    return apply(selected_width(widths, count))


def make_vertex_compactor(n_fwords: int, dummy_vertex: int, pqcap: int,
                          device: torch.device) -> Callable:
    """Build ``compact(F (n_fwords,) int32) -> (VQ (pqcap,) int64, fcount)``:
    cumsum stream-compaction of the set frontier BITS into a static-width
    vertex queue, dummy-padded with ``dummy_vertex``; entries beyond
    ``pqcap`` are dropped (they go to a spare slot that is sliced off)."""
    verts = torch.arange(n_fwords * 32, dtype=torch.int64, device=device)
    bitpos = torch.arange(32, dtype=torch.int32, device=device)

    def compact(F: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        bits = ((F[:, None] >> bitpos[None, :]) & 1).reshape(-1).bool()
        pos = torch.cumsum(bits, 0) - 1
        idx = torch.where(bits & (pos < pqcap), pos, pqcap)
        VQ = torch.full((pqcap + 1,), dummy_vertex, dtype=torch.int64,
                        device=device)
        VQ.scatter_(0, idx, verts)
        return VQ[:pqcap], bits.sum()

    return compact


def expand_push_queue(dev: BVSSDevice, VQ: torch.Tensor, R: int,
                      num_vss: int) -> torch.Tensor:
    """Expand a compacted frontier-vertex queue into the (|VQ|·R,) VSS ids
    the push phase processes: every VSS of each vertex's own slice set,
    dummy-padded to the static factor R = ``max_vss_per_set``.  Dummy
    vertices map to the empty range, so their rows are the all-zero dummy
    VSS ``num_vss``."""
    starts = dev.vss_of_vertex_start[VQ]
    ends = dev.vss_of_vertex_end[VQ]
    r = torch.arange(R, dtype=torch.int32, device=VQ.device)
    vss = starts[:, None] + r[None, :]
    valid = r[None, :] < (ends - starts)[:, None]
    return torch.where(valid, vss, num_vss).reshape(-1)


def make_compactor(dev: BVSSDevice, num_vss: int, qcap: int) -> Callable:
    """Build ``compact(set_active (n_sets,) bool) -> (Q (qcap,) int64,
    count 0-d tensor)``: cumsum stream-compaction of active slice sets into
    the static-width VSS queue (the stand-in for the paper's atomic queue
    append)."""
    device = dev.masks.device
    vss_ids = torch.arange(num_vss, dtype=torch.int64, device=device)
    v2r = dev.virtual_to_real[:num_vss].to(torch.int64)

    def compact(set_active: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        vss_active = set_active[v2r]
        pos = torch.cumsum(vss_active, 0) - 1
        idx = torch.where(vss_active & (pos < qcap), pos, qcap)
        Q = torch.full((qcap + 1,), num_vss, dtype=torch.int64, device=device)
        Q.scatter_(0, idx, vss_ids)
        return Q[:qcap], vss_active.sum()

    return compact


class QueueHistory(NamedTuple):
    """Per-level frontier history of one traversal: ``Q[lvl - 1]`` is the
    compacted VSS queue the level-``lvl`` pull consumed (the tiles whose
    slice sets intersect the level-``lvl - 1`` frontier) and ``count[lvl -
    1]`` its live count.  Recorded via
    :func:`repro_torch.core.level_pipeline.run_levels_recorded` and replayed
    in reverse by the Brandes backward sweep
    (``repro_torch.analytics.betweenness``).

    The reference preallocates a ``(max_levels + 1, qcap)`` buffer, which
    at its default bound of n + 1 levels is about 40 GB on ``rmat(18)``.
    Here the level loop runs on the host, which knows each level's width,
    so the history keeps only the prefix ``Q[:width]`` the level's pull
    ran at (dummy entries past ``count`` included, as in the reference)."""

    Q: list[torch.Tensor]   # one (width,) int64 queue prefix per level
    count: list[int]        # live VSS count per level


def make_queue_history(widths: list[int]) -> tuple[QueueHistory, Callable]:
    """A fresh, empty :class:`QueueHistory` and the ``record`` hook that
    appends a wave state's queue prefix at the width its count selects
    from the ladder ``widths``."""
    hist0 = QueueHistory(Q=[], count=[])

    def record(hist: QueueHistory, state, lvl: int) -> QueueHistory:
        del lvl  # levels are recorded in order, from 1
        hist.Q.append(state.Q[:selected_width(widths, state.count)])
        hist.count.append(int(state.count))
        return hist

    return hist0, record


def _make_hybrid_step(dev: BVSSDevice, pull: PullFn, push: PushFn,
                      sigma: int, n_rows: int, widths: list[int], *,
                      lazy: bool, direction: str, num_vss: int,
                      n_fwords: int, dummy_vertex: int, R: int,
                      push_cap: int, alpha: float) -> Callable:
    """The direction-optimizing level step (DESIGN §2.3/§2.8).

    Pull side: gather → pull → update over the compacted VSS queue, at the
    ladder width the live count selects.  Push side: compact the frontier
    BITS into a vertex queue, expand each vertex into the ≤ R VSSs of its
    own slice set, and resolve each (vertex, VSS) pair with the one-hot
    push kernel — processing width ``pqcap·R`` regardless of ``num_vss``.

    ``direction``: "pull"/"push" force a branch; "auto" picks per level on
    the host: push iff the frontier fits the cap, the frontier is small
    against the unvisited remainder (the Beamer-α guard), and push's static
    cost undercuts the pull width the ladder would select.  When push's
    static cost cannot beat even the full pull width, auto is pure pull."""
    if direction not in DIRECTIONS:
        raise ConfigError(
            f"direction must be one of {DIRECTIONS}, got {direction!r}")

    def scatter(state: _BlestState, rows: torch.Tensor, h: torch.Tensor,
                lvl: int) -> _BlestState:
        rows = rows.to(torch.int64)
        if lazy:
            # Alg. 3 stage 1: fire-and-forget mark (REDG analogue); misses
            # aim at the dummy row, so every write is the same 1
            marks = state.marks.zero_()
            marks.index_fill_(0, torch.where(h, rows, n_rows), 1)
            return state._replace(marks=marks)
        # Alg. 2: eager visited-check-and-set (ATOMG analogue), the
        # reference's scatter-min of ``lvl``: a hit row whose level is still
        # above ``lvl`` takes ``lvl``; every other entry aims at the dummy
        # row.  All writers of a row store the same value, so plain stores
        # do what the min did, with no atomic per entry (PERF.md has the
        # H100 times of both).  Updates levels in place; the dummy slot n
        # is a sink nobody reads.
        fresh = h & (state.levels[rows] > lvl)
        state.levels.index_fill_(0, torch.where(fresh, rows, n_rows), lvl)
        return state

    def pull_update(state: _BlestState, lvl: int, width: int) -> _BlestState:
        """gather → pull → update over the first ``width`` queue slots
        (all live entries: the queue is compacted and count <= width)."""
        ids = state.Q[:width]
        fbytes = _frontier_bytes(state.F, dev.virtual_to_real[ids], sigma)
        hits = pull(dev.masks[ids], fbytes, sigma)       # (width, spw, 32)
        return scatter(state, dev.row_ids[ids].reshape(-1),
                       hits.reshape(-1), lvl)

    def pull_step(state: _BlestState, lvl: int) -> _BlestState:
        return select_width(widths, state.count,
                            lambda w: pull_update(state, lvl, w))

    if direction == "pull":
        return pull_step

    pqcap = _round_width(push_cap)
    push_cost = pqcap * R
    if direction == "auto" and push_cost >= widths[-1]:
        # push can never undercut even the full pull width
        return pull_step
    compact_vertices = make_vertex_compactor(n_fwords, dummy_vertex, pqcap,
                                             dev.masks.device)

    def push_update(state: _BlestState, lvl: int) -> _BlestState:
        VQ, _ = compact_vertices(state.F)
        ids = expand_push_queue(dev, VQ, R, num_vss)
        bits = (VQ % sigma).to(torch.int32)[:, None].expand(pqcap, R
                                                            ).reshape(-1)
        hits = push(dev.masks[ids], bits, sigma)         # (pqcap*R, spw, 32)
        return scatter(state, dev.row_ids[ids].reshape(-1),
                       hits.reshape(-1), lvl)

    if direction == "push":
        return push_update

    def step(state: _BlestState, lvl: int) -> _BlestState:
        fcount = state.fcount
        use_push = (fcount <= push_cap
                    and push_cost < selected_width(widths, state.count)
                    and np.float32(fcount) * np.float32(alpha)
                    <= np.float32(state.unvisited))
        return push_update(state, lvl) if use_push else pull_step(state, lvl)

    return step


def resolve_push_cap(direction: str, push_cap: int | None, n: int) -> int:
    """The frontier cap a push level tolerates: forced push must hold EVERY
    vertex (a dropped overflow entry is a wrong answer), auto defaults to
    the tunable small-frontier cap."""
    if direction == "push":
        return n
    return push_cap if push_cap is not None else DEFAULT_PUSH_CAP


def make_blest_bfs(problem: BlestProblem, *, lazy: bool,
                   pull_impl: PullFn | None = None,
                   push_impl: PushFn | None = None,
                   use_kernels: bool = True, buckets: int = 2,
                   widths: list[int] | None = None,
                   direction: str = "auto", push_cap: int | None = None,
                   alpha: float = 4.0, max_levels: int | None = None
                   ) -> Callable[[int], torch.Tensor]:
    """Build the fused BLEST BFS ``f(src) -> levels (n,) int32 tensor``
    (Alg. 2 eager / Alg. 3 lazy) on the problem's device.

    pull_impl:   custom pull (masks, fbytes, sigma) -> hits.
    push_impl:   custom push (masks, bits, sigma) -> hits (the push seam).
    use_kernels: route pull, push and the finalise sweep through the kernel
                 entry points (the CUDA kernels on a CUDA problem, their
                 twins on a CPU one); False = the plain PyTorch twins on
                 any device.
    buckets:     graduations of the pull-width ladder (:func:`queue_widths`).
    widths:      explicit pull-width ladder (ascending; overrides buckets).
    direction:   "auto" (per-level host switch), "pull", "push".
    push_cap:    auto-mode frontier cap (None = DEFAULT_PUSH_CAP).
    alpha:       saturation guard: auto only pushes while
                 ``alpha * popcount(F) <= unvisited``.
    max_levels:  stop after this many levels (default n + 1).
    """
    p = problem
    sigma = p.sigma
    n = p.n
    if direction not in DIRECTIONS:
        raise ConfigError(
            f"direction must be one of {DIRECTIONS}, got {direction!r}")
    if widths is None:
        widths = queue_widths(p.num_vss, buckets)
    qcap = widths[-1]
    max_lv = max_levels if max_levels is not None else n + 1
    cap = resolve_push_cap(direction, push_cap, n)

    if pull_impl is not None:
        pull = pull_impl
    elif use_kernels:
        pull = pull_vss_kernel
    else:
        pull = pull_vss_twin
    if push_impl is not None:
        push = push_impl
    elif use_kernels:
        push = push_vss_kernel
    else:
        push = bvss_push_ref
    fin_impl = finalize_pack_sweep if use_kernels else finalize_pack_ref

    dev = p.dev
    device = p.device
    popcount = _make_popcount(device)
    compact = make_compactor(dev, p.num_vss, qcap)
    step = _make_hybrid_step(dev, pull, push, sigma, n, widths, lazy=lazy,
                             direction=direction, num_vss=p.num_vss,
                             n_fwords=p.n_fwords, dummy_vertex=n,
                             R=p.max_vss_per_set, push_cap=cap, alpha=alpha)

    def sync(count: torch.Tensor, F: torch.Tensor) -> tuple[int, int]:
        """The level's one device-to-host copy: (live VSS count, popcount F)."""
        c, f = torch.stack([count, popcount(F)]).tolist()
        return int(c), int(f)

    def finalize(state: _BlestState, lvl: int) -> _BlestState:
        if lazy:
            # Alg. 3 stage 2 fused: finalise + pack + set flags in one sweep
            lv_n, fwords, set_active = fin_impl(
                state.levels[:n], lvl, sigma=sigma, n_fwords=p.n_fwords,
                n_sets=p.n_sets, marks=state.marks[:n])
            state.levels[:n].copy_(lv_n)
        else:
            # eager: levels already final; the sweep just packs + flags
            _, fwords, set_active = fin_impl(
                state.levels[:n], lvl, sigma=sigma, n_fwords=p.n_fwords,
                n_sets=p.n_sets)
        Q, count = compact(set_active)
        count, fcount = sync(count, fwords)
        return state._replace(F=fwords, Q=Q, count=count, fcount=fcount,
                              unvisited=state.unvisited - fcount,
                              cont=count > 0)

    pipe = LevelPipeline(step=step, finalize=finalize,
                         active=lambda s: s.cont)

    def bfs(src: int) -> torch.Tensor:
        src = int(src)
        levels = torch.full((n + 1,), INF, dtype=torch.int32, device=device)
        levels[src] = 0
        F = torch.zeros((p.n_fwords,), dtype=torch.int32, device=device)
        F[src // 32] = _i32(1 << (src % 32))
        set0 = torch.zeros((p.n_sets,), dtype=torch.bool, device=device)
        set0[src // sigma] = True
        Q, count = compact(set0)
        count, fcount = sync(count, F)
        marks0 = torch.zeros((n + 1 if lazy else 1,), dtype=torch.uint8,
                             device=device)
        state = _BlestState(levels, F, Q, count, marks0, n - 1, fcount,
                            count > 0)
        state, _ = run_levels(pipe, state, max_levels=max_lv)
        return state.levels[:n]

    return bfs


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------
#: engines this port runs; the reference's others come in later slices
ENGINES = ("blest", "blest_lazy")
#: engines with a (sources (S,)) -> (n, S) signature, built via n_sources=
MULTI_ENGINES = ("multi_source",)


def make_engine(g: Graph, engine: str, *, sigma: int = 8,
                bvss: BVSS | None = None,
                problem: BlestProblem | None = None,
                device: "str | torch.device | None" = None,
                pull_impl: PullFn | None = None,
                push_impl: PushFn | None = None,
                use_kernels: bool = True, buckets: int = 2,
                widths: list[int] | None = None,
                direction: str = "auto", push_cap: int | None = None,
                alpha: float = 4.0,
                n_sources: int | None = None) -> Callable:
    """Build a BFS callable ``f(src) -> levels`` for the named engine.

    ``problem`` lets callers that already hold a :class:`BlestProblem`
    (``prepare``) skip rebuilding the device BVSS; otherwise one is built
    from ``bvss`` (or from ``g``) on ``device`` (default: the card).
    ``engine="multi_source"`` builds the batched BVSS bit-SpMM engine
    ``f(sources (S,)) -> levels (n, S)`` and requires ``n_sources``.
    """
    if engine not in ENGINES + MULTI_ENGINES:
        raise ConfigError(
            f"engine {engine!r} is not ported to PyTorch yet: this port "
            f"runs {ENGINES + MULTI_ENGINES}; the Table-2 baselines (brs, "
            f"dense_pull, csr_*, dirop) come with the baselines slice")
    if problem is None:
        b = bvss if bvss is not None else build_bvss(g, sigma=sigma)
        problem = BlestProblem.build(b, device)
    if engine == "multi_source":
        from repro_torch.core.multi_source import make_multi_source_bfs
        if n_sources is None:
            raise ValueError("multi_source engine needs n_sources")
        return make_multi_source_bfs(g, n_sources, problem=problem,
                                     use_kernel=use_kernels,
                                     buckets=buckets, widths=widths,
                                     direction=direction, push_cap=push_cap)
    return make_blest_bfs(problem, lazy=(engine == "blest_lazy"),
                          pull_impl=pull_impl, push_impl=push_impl,
                          use_kernels=use_kernels, buckets=buckets,
                          widths=widths, direction=direction,
                          push_cap=push_cap, alpha=alpha)
