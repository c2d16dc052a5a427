"""Single-source BLEST engines (paper §4, Algorithms 2 & 3) on PyTorch, the
port of ``repro/core/bfs.py``.

Engines
-------
reference      host NumPy queue BFS (test oracle)
blest          Alg. 2: BVSS queue, frontier-aware blocks, eager scatter-min
blest_lazy     Alg. 3: lazy marks (fire-and-forget) + dense finalise sweep
brs            BerryBees-like: frontier-OBLIVIOUS sweep over every VSS
dense_pull     bitmap pull over the dense (n, n/32) adjacency
csr_push       edge-parallel CSR push (Gunrock-like baseline)
csr_pull       edge-parallel CSR pull
dirop          direction-optimising CSR (Beamer): push/pull per level

The last five are the paper's Table-2 baselines.

The level step is the reference's fused, direction-optimizing step
(DESIGN §2.3/§2.8): one batched pull over the compacted VSS queue (CUDA
``bvss_pull``) and one scatter or, on small frontiers, one push over the
frontier vertices' own VSSs; one fused finalise + frontier-pack + set-flag
sweep (CUDA ``finalize_pack_sweep``) feeding cumsum compaction.  The push
is one launch of CUDA ``bvss_push_level``, which walks the frontier and
stores the levels (lazy: the marks) itself; the reference's unfused push
(vertex queue, expansion, ``bvss_push``, scatter) stays behind the
``push_impl`` seam and ``use_kernels=False``.

What changes from the reference is where the control lives.  The
reference keeps the loop, the queue-width ladder (``lax.cond``) and the
push/pull choice (``lax.cond``) on the device.  Here the level loop is a
host loop (:func:`repro_torch.core.level_pipeline.run_levels`) that reads
the level's scalars back once per level, and the host picks the width and
the direction from those scalars with the reference's exact tests.  Each
kernel is then launched at the width the host picked.

A problem built over a mesh (:meth:`BlestProblem.build_sharded`,
:meth:`BlestProblem.build_sharded_2d`) runs the reference's mesh-native
engines (DESIGN §2.4) SPMD: every rank runs the same level loop on its own
shard's rows, exchanges the frontier words through ``torch.distributed``
and all-reduces the continuation test, which rides in the level's one
host copy; the engine returns the whole global level array on every rank.

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

from repro_torch.core.bvss import (BVSS, BVSSDevice, ShardedBVSS,
                                   ShardedBVSS2D, ShardedBVSSDevice,
                                   build_bvss, resolve_device, shard_ptrs,
                                   shard_to_device, shard_to_device_2d,
                                   to_device)
from repro_torch.core.level_pipeline import (LevelPipeline, global_any,
                                             run_levels)
from repro_torch.distributed.bfs_dist import frontier_all_gather
from repro_torch.distributed.collectives import (all_gather_tiled,
                                                 axis_size,
                                                 butterfly_frontier_exchange,
                                                 butterfly_or_allreduce)
from repro_torch.errors import ConfigError, GraphValidationError
from repro_torch.graphs import Graph, src_of_edges, to_dense_bits
from repro_torch.kernels import (bvss_push_level, finalize_pack_sweep,
                                 pull_vss_kernel)
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


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 (n_words,) -> bool (n_words*32,): inverse of :func:`_pack_bits`."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts[None, :]) & 1).reshape(-1) != 0


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
    dev: BVSSDevice | ShardedBVSSDevice
    # static push expansion factor: every pushing vertex enqueues at most
    # this many VSSs of its own slice set (DESIGN §2.8)
    max_vss_per_set: int = 1
    # mesh-native row partition (DESIGN §2.4); mesh=None = single-device.
    # ``dev`` then holds this rank's own shard only
    mesh: object | None = None
    axis: str = "data"
    n_shards: int = 1
    rows_per_shard: int = 0
    # 2-D row × column partition (DESIGN §2.4): col_axis=None = 1-D.
    # Column block j owns, inside every row block, the cols_per_block
    # sources [i·rps + j·cpb, i·rps + (j+1)·cpb) — the butterfly exchange
    # moves one rps/cols/32-word segment per rank per level.
    col_axis: str | None = None
    n_col_shards: int = 1
    cols_per_block: int = 0
    # every shard's per-set VSS offsets on a 1-D mesh, (n_shards, n_sets
    # + 1) host int64 (row d = shard d's ``real_ptrs``), the same on every
    # rank: what an edge update decides and patches from (ROADMAP.md
    # queue 1 item 11e), since ``dev`` holds this rank's block alone
    shard_ptrs: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.dev.masks.device

    @property
    def is_2d(self) -> bool:
        return self.col_axis is not None

    @staticmethod
    def build(bvss: BVSS, device: "str | torch.device | None" = None
              ) -> "BlestProblem":
        return BlestProblem(n=bvss.n, sigma=bvss.sigma, n_sets=bvss.n_sets,
                            num_vss=bvss.num_vss,
                            n_fwords=bvss.n_frontier_words,
                            dev=to_device(bvss, device),
                            max_vss_per_set=bvss.max_vss_per_set)

    @staticmethod
    def build_sharded(sb: ShardedBVSS, mesh, axis: str = "data",
                      device: "str | torch.device | None" = None
                      ) -> "BlestProblem":
        """Row-sharded problem: ``dev`` holds this rank's shard of ``sb``
        on the rank's device; the engines run the level loop on every rank
        of ``mesh``'s ``axis``."""
        if axis_size(mesh, axis) != sb.n_shards:
            raise ValueError(
                f"mesh axis {axis!r} has {axis_size(mesh, axis)} ranks but "
                f"the BVSS is built for {sb.n_shards} shards")
        return BlestProblem(n=sb.n, sigma=sb.sigma, n_sets=sb.n_sets,
                            num_vss=sb.num_vss_pad,
                            n_fwords=sb.n_frontier_words,
                            dev=shard_to_device(sb, mesh, axis,
                                                device=device),
                            mesh=mesh, axis=axis, n_shards=sb.n_shards,
                            rows_per_shard=sb.rows_per_shard,
                            max_vss_per_set=sb.max_vss_per_set,
                            shard_ptrs=shard_ptrs(sb))

    @staticmethod
    def build_sharded_2d(sb: ShardedBVSS2D, mesh,
                         device: "str | torch.device | None" = None
                         ) -> "BlestProblem":
        """2-D row × column problem: rank (i, j) of the mesh owns BVSS
        block i·cols + j.  ``n_sets``/``n_fwords`` become the per-rank
        LOCAL column-block quantities — the engines never materialise a
        global frontier."""
        row_axis, col_axis = mesh.mesh_dim_names
        shape = tuple(mesh.shape)
        if shape != (sb.rows, sb.cols):
            raise ConfigError(
                f"mesh shape {shape} does not match the 2-D BVSS built "
                f"for ({sb.rows}, {sb.cols}) blocks")
        return BlestProblem(n=sb.n, sigma=sb.sigma,
                            n_sets=sb.n_sets_local,
                            num_vss=sb.num_vss_pad,
                            n_fwords=sb.n_frontier_words_local,
                            dev=shard_to_device_2d(sb, mesh, device=device),
                            mesh=mesh, axis=row_axis, n_shards=sb.rows,
                            rows_per_shard=sb.rows_per_shard,
                            col_axis=col_axis, n_col_shards=sb.cols,
                            cols_per_block=sb.cols_per_block,
                            max_vss_per_set=sb.max_vss_per_set)


class RankLayout(NamedTuple):
    """Where this rank's rows sit in the global vertex space, and the
    process groups that reduce and gather over the whole mesh (DESIGN
    §2.4).  On one device the rank holds every row and has no group."""

    rows: int           # local rows: n, or rows_per_shard on a mesh
    first_row: int      # global id of local row 0
    groups: tuple       # reduction groups: () on one device, the axis
                        #   group (1-D), the column then the row group (2-D)
    row_group: object   # the row-axis group that gathers row blocks (None)
    leader: bool        # rank (0, ..., 0) of the mesh (True on one device)


def rank_layout(p: "BlestProblem") -> RankLayout:
    """The :class:`RankLayout` of this rank of ``p``'s mesh."""
    if p.mesh is None:
        return RankLayout(p.n, 0, (), None, True)
    mesh = p.mesh
    i = mesh.get_local_rank(p.axis)
    rows = mesh.get_group(p.axis)
    if p.is_2d:
        return RankLayout(p.rows_per_shard, i * p.rows_per_shard,
                          (mesh.get_group(p.col_axis), rows), rows,
                          i == 0 and mesh.get_local_rank(p.col_axis) == 0)
    return RankLayout(p.rows_per_shard, i * p.rows_per_shard, (rows,), rows,
                      i == 0)


def gather_rows(x: torch.Tensor, lay: RankLayout, n: int) -> torch.Tensor:
    """Every rank's local row block ``x`` (``lay.rows`` leading rows) in
    row-block order, cut to the ``n`` global rows, on every rank: the
    answer of a sharded engine (not a level's traffic, so the comm ledger
    does not record it).  On one device ``x[:n]``."""
    if lay.row_group is None:
        return x[:n]
    return all_gather_tiled(x.contiguous(), lay.row_group)[:n]


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


def _make_hybrid_step(dev: BVSSDevice, pull: PullFn, push: PushFn | None,
                      sigma: int, n_rows: int, widths: list[int], *,
                      lazy: bool, direction: str, num_vss: int,
                      n_fwords: int, dummy_vertex: int, R: int,
                      push_cap: int, alpha: float) -> Callable:
    """The direction-optimizing level step (DESIGN §2.3/§2.8).

    Pull side: gather → pull → update over the compacted VSS queue, at the
    ladder width the live count selects.  Push side, with ``push=None``:
    one :func:`~repro_torch.kernels.bvss_push_level` over the packed
    frontier, which stores into the levels (lazy: the zeroed marks)
    itself.  With a ``push`` function, the reference's unfused push:
    compact the frontier BITS into a vertex queue, expand each vertex into
    the ≤ R VSSs of its own slice set, resolve each (vertex, VSS) pair with
    ``push`` and scatter — processing width ``pqcap·R`` regardless of
    ``num_vss``.  Both leave the same levels and marks on every real row:
    nothing is dropped, since auto pushes only when the frontier fits the
    cap and forced push sets the cap to n (:func:`resolve_push_cap`).

    ``direction``: "pull"/"push" force a branch; "auto" picks per level on
    the host: push iff the frontier fits the cap, the frontier is small
    against the unvisited remainder (the Beamer-α guard), and push's static
    cost undercuts the pull width the ladder would select.  When push's
    static cost cannot beat even the full pull width, auto is pure pull.

    ``n_rows`` is the scatter extent: the global ``n`` single-device, the
    shard's ``rows_per_shard`` under a mesh (row ids are local there —
    while the frontier words, and hence the push's frontier vertices, are
    GLOBAL replicas, so every shard expands the same vertices into its own
    local VSS ids and both branches stay free of collectives)."""
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
    if push is None:
        operands = (dev.vss_of_vertex_start, dev.vss_of_vertex_end,
                    dev.masks, dev.row_ids)

        def push_update(state: _BlestState, lvl: int) -> _BlestState:
            # one launch (lazy: a memset and a launch), in place
            if lazy:
                bvss_push_level(state.F, *operands, lvl, sigma=sigma,
                                marks=state.marks.zero_())
            else:
                bvss_push_level(state.F, *operands, lvl, sigma=sigma,
                                levels=state.levels)
            return state
    else:
        compact_vertices = make_vertex_compactor(n_fwords, dummy_vertex,
                                                 pqcap, dev.masks.device)

        def push_update(state: _BlestState, lvl: int) -> _BlestState:
            VQ, _ = compact_vertices(state.F)
            ids = expand_push_queue(dev, VQ, R, num_vss)
            bits = (VQ % sigma).to(torch.int32)[:, None].expand(
                pqcap, R).reshape(-1)
            hits = push(dev.masks[ids], bits, sigma)     # (pqcap*R, spw, 32)
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
    push_impl:   custom push (masks, bits, sigma) -> hits (the push seam):
                 push levels take the unfused path around it (vertex
                 queue, expansion, ``push_impl``, scatter).
    use_kernels: route pull, push and the finalise sweep through the kernel
                 entry points (the CUDA kernels on a CUDA problem, their
                 twins on a CPU one); a push level is then one
                 ``bvss_push_level``.  False = the plain PyTorch twins on
                 any device, the push unfused around ``bvss_push_ref``.
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
        push = None                 # the one-launch push level
    else:
        push = bvss_push_ref
    fin_impl = finalize_pack_sweep if use_kernels else finalize_pack_ref

    if p.mesh is not None:
        if p.is_2d:
            return _make_blest_bfs_sharded_2d(p, pull=pull, widths=widths,
                                              qcap=qcap, max_lv=max_lv,
                                              direction=direction)
        return _make_blest_bfs_sharded(p, lazy=lazy, pull=pull, push=push,
                                       fin_impl=fin_impl, widths=widths,
                                       qcap=qcap, max_lv=max_lv,
                                       direction=direction, push_cap=cap,
                                       alpha=alpha)

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
# mesh-native engines (DESIGN §2.4)
# ---------------------------------------------------------------------------
def _local_levels0(src: int, first_row: int, rps: int,
                   device: torch.device) -> torch.Tensor:
    """A shard's initial ``(rps + 1,)`` levels: 0 at the source when this
    shard's rows ``[first_row, first_row + rps)`` hold it, else all INF
    (slot ``rps`` is the dummy row sink)."""
    levels = torch.full((rps + 1,), INF, dtype=torch.int32, device=device)
    if first_row <= src < first_row + rps:
        levels[src - first_row] = 0
    return levels


def _make_blest_bfs_sharded(p: BlestProblem, *, lazy: bool, pull: PullFn,
                            push: PushFn | None, fin_impl: Callable,
                            widths: list[int], qcap: int, max_lv: int,
                            direction: str, push_cap: int, alpha: float
                            ) -> Callable[[int], torch.Tensor]:
    """The mesh-native BLEST engine (DESIGN §2.4), one rank's part.  Per
    level, each rank runs the same hybrid step as the single-device engine
    on its local rows (``bvss_pull`` or ``bvss_push_level``, the scatter,
    ``finalize_pack_sweep`` over its ``rps`` rows), all-gathers the
    per-shard frontier words into the global frontier, and all-reduces the
    convergence test (:func:`~repro_torch.core.level_pipeline.global_any`),
    whose result rides in the level's one host copy.

    Push levels need NO extra collective (DESIGN §2.8): the push walks the
    gathered global frontier replica every rank already holds and expands
    it through the rank's own vertex → local-VSS map.  The host's
    direction choice may even differ across ranks (per-shard VSS counts
    differ), because both branches are free of collectives."""
    mesh, axis = p.mesh, p.axis
    groups = (mesh.get_group(axis),)
    sigma, n = p.sigma, p.n
    rps = p.rows_per_shard
    lwords = rps // 32
    first_row = mesh.get_local_rank(axis) * rps
    dev = p.dev
    device = p.device
    all_sets = torch.arange(p.n_sets, dtype=torch.int32, device=device)
    popcount = _make_popcount(device)
    compact = make_compactor(dev, p.num_vss, qcap)
    step = _make_hybrid_step(dev, pull, push, sigma, rps, widths, lazy=lazy,
                             direction=direction, num_vss=p.num_vss,
                             n_fwords=p.n_fwords, dummy_vertex=n,
                             R=p.max_vss_per_set, push_cap=push_cap,
                             alpha=alpha)

    def sync(count: torch.Tensor, F: torch.Tensor
             ) -> tuple[int, int, bool]:
        """The level's one device-to-host copy: (live local VSS count,
        popcount of the global F, whether any shard has work)."""
        live = global_any(count > 0, groups)
        c, f, g = torch.stack([count, popcount(F),
                               live.to(count.dtype)]).tolist()
        return int(c), int(f), bool(g)

    def finalize(state: _BlestState, lvl: int) -> _BlestState:
        # local fused sweep over THIS shard's rows; its local set flags
        # are meaningless (sets are global) and discarded
        if lazy:
            lv_loc, fw_loc, _ = fin_impl(
                state.levels[:rps], lvl, sigma=sigma, n_fwords=lwords,
                n_sets=rps // sigma, marks=state.marks[:rps])
            state.levels[:rps].copy_(lv_loc)
        else:
            _, fw_loc, _ = fin_impl(state.levels[:rps], lvl, sigma=sigma,
                                    n_fwords=lwords, n_sets=rps // sigma)
        # the one cross-rank term: σ-bit frontier words, all-gathered
        F = frontier_all_gather(fw_loc, mesh, axis)      # (n_fwords,)
        Q, count = compact(_frontier_bytes(F, all_sets, sigma) != 0)
        count, fcount, live = sync(count, F)
        return state._replace(F=F, Q=Q, count=count, fcount=fcount,
                              unvisited=state.unvisited - fcount,
                              cont=live)

    pipe = LevelPipeline(step=step, finalize=finalize,
                         active=lambda s: s.cont)

    def bfs(src: int) -> torch.Tensor:
        src = int(src)
        levels = _local_levels0(src, first_row, rps, device)
        F = torch.zeros((p.n_fwords,), dtype=torch.int32, device=device)
        F[src // 32] = _i32(1 << (src % 32))
        set0 = torch.zeros((p.n_sets,), dtype=torch.bool, device=device)
        set0[src // sigma] = True
        Q, count = compact(set0)
        count, fcount, live = sync(count, F)
        marks0 = torch.zeros((rps + 1 if lazy else 1,), dtype=torch.uint8,
                             device=device)
        state = _BlestState(levels, F, Q, count, marks0, n - 1, fcount, live)
        state, _ = run_levels(pipe, state, max_levels=max_lv)
        return gather_rows(state.levels[:rps], rank_layout(p), n)

    return bfs


def _make_blest_bfs_sharded_2d(p: BlestProblem, *, pull: PullFn,
                               widths: list[int], qcap: int, max_lv: int,
                               direction: str
                               ) -> Callable[[int], torch.Tensor]:
    """The 2-D (row × column) mesh-native BLEST engine (DESIGN §2.4), one
    rank's part.

    Rank (i, j) pulls its ROW block of vertices from its COLUMN block of
    frontier words, so per level it runs the same bucketed pull as the 1-D
    engine over ``1/cols`` of the frontier, then two butterfly collectives
    replace the flat all-gather: an OR all-reduce of the packed partial hit
    words over the COLUMN axis (every column block saw a different frontier
    slice, so hits are partial), and a segment all-gather of the fresh
    frontier words over the ROW axis (rank (i, j) contributes row block
    i's j-th word segment, receiving its full column block).  Convergence
    is one all-reduce over BOTH axes.

    The 2-D partition is pull-only: hits are accumulated as marks and
    reduced BEFORE levels update (a partial eager store would commit local
    hits that another column block already discovered at an earlier level
    — wrong), which makes the eager and lazy variants one mark-based body;
    the level update after the OR is plain glue, so ``bvss_pull`` is the
    one kernel.  Forced ``direction="push"`` is a :class:`ConfigError`
    (the push walks GLOBAL frontier replicas that no 2-D rank holds)."""
    if direction == "push":
        raise ConfigError(
            "the 2-D row × column partition is pull-only (DESIGN §2.4); "
            "direction='push' needs the global frontier replica only the "
            "1-D partition holds — use a 1-D mesh or direction='pull'")
    mesh, rax, cax = p.mesh, p.axis, p.col_axis
    groups = (mesh.get_group(cax), mesh.get_group(rax))
    sigma, n = p.sigma, p.n
    rps = p.rows_per_shard
    lwords = rps // 32
    cpb = p.cols_per_block
    wpc = lwords // p.n_col_shards       # words per column segment
    ncw = p.n_fwords                     # per-rank column-block words
    i, j = mesh.get_local_rank(rax), mesh.get_local_rank(cax)
    dev = p.dev
    device = p.device
    all_sets = torch.arange(p.n_sets, dtype=torch.int32, device=device)
    compact = make_compactor(dev, p.num_vss, qcap)

    def sync(count: torch.Tensor) -> tuple[int, bool]:
        """The level's one device-to-host copy: (live local VSS count,
        whether any rank has work)."""
        live = global_any(count > 0, groups)
        c, g = torch.stack([count, live.to(count.dtype)]).tolist()
        return int(c), bool(g)

    def step(state: _BlestState, lvl: int) -> _BlestState:
        def pull_marks(width: int) -> torch.Tensor:
            ids = state.Q[:width]
            fbytes = _frontier_bytes(state.F, dev.virtual_to_real[ids],
                                     sigma)
            hits = pull(dev.masks[ids], fbytes, sigma)
            rows = dev.row_ids[ids].reshape(-1).to(torch.int64)
            marks = state.marks.zero_()
            marks.index_fill_(0, torch.where(hits.reshape(-1), rows, rps), 1)
            return marks
        return state._replace(marks=select_width(widths, state.count,
                                                 pull_marks))

    def finalize(state: _BlestState, lvl: int) -> _BlestState:
        # partial hits -> full row-block hits (butterfly OR over cols)
        hw = butterfly_or_allreduce(
            _pack_bits(state.marks[:rps] > 0, lwords), mesh, cax)
        newly = _unpack_bits(hw) & (state.levels[:rps] == INF)
        state.levels[:rps].masked_fill_(newly, lvl)
        # fresh frontier: this row block's j-th word segment, exchanged
        # along the row axis into the full column block
        seg = _pack_bits(newly, lwords)[j * wpc:(j + 1) * wpc]
        F = butterfly_frontier_exchange(seg, mesh, rax)      # (ncw,)
        Q, count = compact(_frontier_bytes(F, all_sets, sigma) != 0)
        count, live = sync(count)
        return state._replace(F=F, Q=Q, count=count, cont=live)

    pipe = LevelPipeline(step=step, finalize=finalize,
                         active=lambda s: s.cont)

    def bfs(src: int) -> torch.Tensor:
        src = int(src)
        levels = _local_levels0(src, i * rps, rps, device)
        # the source's frontier bit lives only in its own column block
        F = torch.zeros((ncw,), dtype=torch.int32, device=device)
        off = src % rps
        if off // cpb == j:
            c = (src // rps) * cpb + (off - j * cpb)
            F[c // 32] = _i32(1 << (c % 32))
        Q, count = compact(_frontier_bytes(F, all_sets, sigma) != 0)
        count, live = sync(count)
        marks0 = torch.zeros((rps + 1,), dtype=torch.uint8, device=device)
        state = _BlestState(levels, F, Q, count, marks0, n - 1, 0, live)
        state, _ = run_levels(pipe, state, max_levels=max_lv)
        # column-replicated row blocks: gather along the row axis
        return gather_rows(state.levels[:rps], rank_layout(p), n)

    return bfs


# ---------------------------------------------------------------------------
# BRS baseline (BerryBees-like): frontier-oblivious slice-set sweep
# ---------------------------------------------------------------------------
class _BrsState(NamedTuple):
    levels: torch.Tensor  # (n,) int32
    marks: torch.Tensor   # (n + 1,) uint8 hit marks, slot n = dummy row sink
    F: torch.Tensor       # (n_fwords,) int32 packed frontier
    cont: bool            # some vertex was new (host copy)


def make_brs_bfs(problem: BlestProblem, *, use_kernels: bool = True,
                 max_levels: int | None = None
                 ) -> Callable[[int], torch.Tensor]:
    """The BRS baseline ``f(src) -> levels (n,) int32 tensor``: every level
    pulls EVERY VSS against the frontier (paper drawback #2), whatever the
    frontier's size.

    The pull is the BLEST engines' (CUDA ``bvss_pull`` on a CUDA problem;
    the reference pulls BRS with its many-op jnp pull), so the gap to BLEST
    is the sweep alone.  The reference's scatter-min over every row of the
    graph becomes a mark of 1 at hit rows (misses aim at the dummy row n)
    and the lazy ``finalize_pack_sweep``, which sets ``lvl`` where marked
    and still INF: the same levels, no atomic per entry."""
    p = problem
    sigma, n = p.sigma, p.n
    max_lv = max_levels if max_levels is not None else n + 1
    pull = pull_vss_kernel if use_kernels else pull_vss_twin
    fin_impl = finalize_pack_sweep if use_kernels else finalize_pack_ref
    if p.mesh is not None:
        if p.is_2d:
            raise ConfigError(
                "the BRS baseline has no 2-D partition path — prepare with "
                "a 1-D mesh or the blest/blest_lazy engines")
        return _make_brs_bfs_sharded(p, pull=pull, fin_impl=fin_impl,
                                     max_lv=max_lv)
    dev = p.dev
    device = p.device
    masks = dev.masks[:p.num_vss]
    sets = dev.virtual_to_real[:p.num_vss]
    rows = dev.row_ids[:p.num_vss].reshape(-1).to(torch.int64)

    def step(s: _BrsState, lvl: int) -> _BrsState:
        hits = pull(masks, _frontier_bytes(s.F, sets, sigma), sigma)
        s.marks.zero_().index_fill_(
            0, torch.where(hits.reshape(-1), rows, n), 1)
        return s

    def finalize(s: _BrsState, lvl: int) -> _BrsState:
        levels, F, set_active = fin_impl(
            s.levels, lvl, sigma=sigma, n_fwords=p.n_fwords,
            n_sets=p.n_sets, marks=s.marks[:n])
        return _BrsState(levels, s.marks, F, bool(set_active.any()))

    pipe = LevelPipeline(step=step, finalize=finalize,
                         active=lambda s: s.cont)

    def bfs(src: int) -> torch.Tensor:
        src = int(src)
        levels = torch.full((n,), INF, dtype=torch.int32, device=device)
        levels[src] = 0
        F = torch.zeros((p.n_fwords,), dtype=torch.int32, device=device)
        F[src // 32] = _i32(1 << (src % 32))
        marks = torch.zeros((n + 1,), dtype=torch.uint8, device=device)
        state, _ = run_levels(pipe, _BrsState(levels, marks, F, True),
                              max_levels=max_lv)
        return state.levels

    return bfs


def _make_brs_bfs_sharded(p: BlestProblem, *, pull: PullFn,
                          fin_impl: Callable, max_lv: int
                          ) -> Callable[[int], torch.Tensor]:
    """Mesh-native BRS, one rank's part: the frontier-oblivious sweep
    visits every VSS of the rank's SHARD each level (paper drawback #2
    doesn't shrink under a mesh — that is the point of the baseline);
    only the frontier words cross ranks, and the convergence test."""
    mesh, axis = p.mesh, p.axis
    groups = (mesh.get_group(axis),)
    sigma, n = p.sigma, p.n
    rps = p.rows_per_shard
    lwords = rps // 32
    first_row = mesh.get_local_rank(axis) * rps
    dev = p.dev
    device = p.device
    masks = dev.masks[:p.num_vss]
    sets = dev.virtual_to_real[:p.num_vss]
    rows = dev.row_ids[:p.num_vss].reshape(-1).to(torch.int64)

    def step(s: _BrsState, lvl: int) -> _BrsState:
        hits = pull(masks, _frontier_bytes(s.F, sets, sigma), sigma)
        s.marks.zero_().index_fill_(
            0, torch.where(hits.reshape(-1), rows, rps), 1)
        return s

    def finalize(s: _BrsState, lvl: int) -> _BrsState:
        levels, fw_loc, set_active = fin_impl(
            s.levels, lvl, sigma=sigma, n_fwords=lwords,
            n_sets=rps // sigma, marks=s.marks[:rps])
        F = frontier_all_gather(fw_loc, mesh, axis)
        live = bool(global_any(set_active.any(), groups))
        return _BrsState(levels, s.marks, F, live)

    pipe = LevelPipeline(step=step, finalize=finalize,
                         active=lambda s: s.cont)

    def bfs(src: int) -> torch.Tensor:
        src = int(src)
        levels = _local_levels0(src, first_row, rps, device)[:rps]
        F = torch.zeros((p.n_fwords,), dtype=torch.int32, device=device)
        F[src // 32] = _i32(1 << (src % 32))
        marks = torch.zeros((rps + 1,), dtype=torch.uint8, device=device)
        state, _ = run_levels(pipe, _BrsState(levels, marks, F, True),
                              max_levels=max_lv)
        return gather_rows(state.levels, rank_layout(p), n)

    return bfs


# ---------------------------------------------------------------------------
# dense bitmap pull (naive SpMSpV lower bound)
# ---------------------------------------------------------------------------
def make_dense_pull_bfs(g: Graph, *, max_levels: int | None = None,
                        device: "str | torch.device | None" = None
                        ) -> Callable[[int], torch.Tensor]:
    """``f(src) -> levels (n,) int32``: each level ANDs the packed frontier
    into every row of the dense pull adjacency (:func:`to_dense_bits`),
    O(n^2/32) words a level, so for small graphs only.  A host loop with
    one host copy (``new.any()``) per level."""
    device = resolve_device(device)
    n = g.n
    n_words = (n + 31) // 32
    adj = torch.from_numpy(to_dense_bits(g)).to(device)   # (n, n_words)
    max_lv = max_levels if max_levels is not None else n + 1

    def bfs(src: int) -> torch.Tensor:
        src = int(src)
        levels = torch.full((n,), INF, dtype=torch.int32, device=device)
        levels[src] = 0
        F = torch.zeros((n_words,), dtype=torch.int32, device=device)
        F[src // 32] = _i32(1 << (src % 32))
        new_pad = torch.zeros((n_words * 32,), dtype=torch.bool,
                              device=device)
        lvl, cont = 0, True
        while cont and lvl < max_lv:
            lvl += 1
            y = (adj & F[None, :]).ne(0).any(dim=1)
            new = y & (levels == INF)
            levels.masked_fill_(new, lvl)
            new_pad[:n] = new
            F = _pack_bits(new_pad, n_words)
            cont = bool(new.any())
        return levels

    return bfs


# ---------------------------------------------------------------------------
# CSR edge-parallel baselines (push / pull / direction-optimised)
# ---------------------------------------------------------------------------
CSR_MODES = ("push", "pull", "dirop")


def make_csr_bfs(g: Graph, mode: str = "push", *, alpha: float = 15.0,
                 max_levels: int | None = None,
                 device: "str | torch.device | None" = None
                 ) -> Callable[[int], torch.Tensor]:
    """Edge-parallel BFS baselines ``f(src) -> levels (n,) int32``.

    push:  next[dst] |= frontier[src] over all out-edges.
    pull:  next[u] |= frontier[v] over all in-edges (v -> u), unvisited u
           only.
    dirop: Beamer switching between the two on the scout count: pull iff
           ``scout * alpha > m``, scout = the frontier's out-degree sum.

    Each level covers all m edges.  The reference's byte scatter-max
    ``nxt.at[e_dst].max(...)`` becomes an ``index_fill_`` of True at the
    edges that carry the frontier, every other edge aimed at a spare slot
    n (the reference has none: the vector is n + 1 long and sliced).  The
    reference's device loop and ``lax.cond`` become a host loop that reads
    ``new.any()`` (and, for dirop, the next scout count) in one host copy
    per level."""
    if mode not in CSR_MODES:
        raise GraphValidationError(
            f"CSR BFS mode must be one of {CSR_MODES}, got {mode!r}")
    device = resolve_device(device)
    n, m = g.n, g.m
    e_src = torch.from_numpy(src_of_edges(g)).to(device)
    e_dst = torch.from_numpy(g.indices.astype(np.int64)).to(device)
    out_deg = torch.from_numpy(g.out_degree.astype(np.int64)).to(device)
    host_deg = g.out_degree
    max_lv = max_levels if max_levels is not None else n + 1

    def scatter_or(vals: torch.Tensor) -> torch.Tensor:
        """(m,) bool per edge -> (n,) bool: OR of the edges into e_dst."""
        nxt = torch.zeros((n + 1,), dtype=torch.bool, device=device)
        nxt.index_fill_(0, torch.where(vals, e_dst, n), True)
        return nxt[:n]

    def push_step(frontier, levels):
        return scatter_or(frontier[e_src]) & (levels == INF)

    def pull_step(frontier, levels):
        # mask by unvisited dst FIRST (the work-saving property of pull)
        unvis = levels == INF
        return scatter_or(frontier[e_src] & unvis[e_dst])

    def bfs(src: int) -> torch.Tensor:
        src = int(src)
        levels = torch.full((n,), INF, dtype=torch.int32, device=device)
        levels[src] = 0
        frontier = torch.zeros((n,), dtype=torch.bool, device=device)
        frontier[src] = True
        scout = int(host_deg[src])
        lvl, cont = 0, True
        while cont and lvl < max_lv:
            lvl += 1
            if mode == "push":
                new = push_step(frontier, levels)
            elif mode == "pull":
                new = pull_step(frontier, levels)
            else:   # the reference's float32 test
                use_pull = (np.float32(scout) * np.float32(alpha)
                            > np.float32(m))
                new = (pull_step if use_pull else push_step)(frontier,
                                                             levels)
            levels.masked_fill_(new, lvl)
            frontier = new
            if mode == "dirop":
                count, scout = torch.stack(
                    [new.sum(), torch.where(new, out_deg, 0).sum()]).tolist()
                cont = count > 0
            else:
                cont = bool(new.any())
        return levels

    return bfs


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------
#: the single-source engines (the paper's Table-2 matrix)
ENGINES = ("dense_pull", "csr_push", "csr_pull", "dirop", "brs", "blest",
           "blest_lazy")
#: engines with a (sources (S,)) -> (n, S) signature, built via n_sources=
MULTI_ENGINES = ("multi_source",)
_CSR_ENGINES = {"csr_push": "push", "csr_pull": "pull", "dirop": "dirop"}


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

    The BVSS engines (``brs``, ``blest``, ``blest_lazy``,
    ``multi_source``) run on ``problem`` when given (``prepare`` passes
    its own), else on one built from ``bvss`` (or from ``g``) on
    ``device`` (default: the card).  The CSR and dense baselines build
    their own arrays from ``g`` on ``device``.
    ``direction``/``push_cap``/``alpha``/``widths`` are the hybrid knobs
    (DESIGN §2.8) of the blest/blest_lazy/multi_source engines.
    ``engine="multi_source"`` builds the batched BVSS bit-SpMM engine
    ``f(sources (S,)) -> levels (n, S)`` and requires ``n_sources``.
    """
    if engine == "dense_pull":
        return make_dense_pull_bfs(g, device=device)
    if engine in _CSR_ENGINES:
        return make_csr_bfs(g, _CSR_ENGINES[engine], device=device)
    if engine not in ENGINES + MULTI_ENGINES:
        raise ConfigError(f"unknown engine {engine!r}: one of "
                          f"{ENGINES + MULTI_ENGINES}")
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
    if engine == "brs":
        return make_brs_bfs(problem, use_kernels=use_kernels)
    return make_blest_bfs(problem, lazy=(engine == "blest_lazy"),
                          pull_impl=pull_impl, push_impl=push_impl,
                          use_kernels=use_kernels, buckets=buckets,
                          widths=widths, direction=direction,
                          push_cap=push_cap, alpha=alpha)
