"""The wave engine of the PyTorch port against the JAX reference, on the CPU.

The same numpy-seeded inputs go through ``repro.core.multi_source`` (its
Pallas ``bvss_spmm`` in interpret mode, as the reference's own tests run
it) and ``repro_torch.core.multi_source`` (the kernel's PyTorch twin).
Every output is integer, so the two must be equal: the twin against the
reference kernel, the wave helpers, the fixed-cohort engine in every
direction, the engine surface level by level, and the wave driver with
refills and harvests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.multi_source as jms
import torch_mesh as tm
from repro.core.bfs import BlestProblem as JProblem
from repro.core.bfs import _frontier_bytes as j_frontier_bytes
from repro.core.bvss import build_bvss as j_build_bvss
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro.kernels import bvss_spmm as j_bvss_spmm
import repro_torch.core.multi_source as tms
from repro_torch.core.bfs import (BlestProblem, _frontier_bytes, make_engine,
                                  reference_bfs)
from repro_torch.core.bvss import build_bvss
from repro_torch.errors import ConfigError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
import repro_torch as rt
from repro_torch.kernels import bvss_spmm, bvss_spmm_mark
from repro_torch.kernels.ref import (bvss_pull_ref, bvss_spmm_mark_ref,
                                     bvss_spmm_ref)
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.iinfo(np.int32).max


def families(gen, from_edges):
    """tests/test_multi_source.py's FAMILIES, plus the planted-partition
    graph on which auto mode takes both branches (tests/test_hybrid.py)."""
    return {
        "rmat": gen.rmat(8, 8, seed=1),
        "grid": gen.grid2d(17, 19),
        "clustered": gen.clustered(8, 32, seed=4),
        "disconnected": from_edges(50, np.array([1, 2, 10]),
                                   np.array([2, 3, 11])),
        "flip": gen.clustered(40, 60, p_in=0.4, seed=1),
    }


J_FAM = families(jgen, j_from_edges)
T_FAM = families(tgen, t_from_edges)
FAMILY_NAMES = ("rmat", "grid", "clustered", "disconnected")


def u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def t32(words: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 carrier, bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def problems(name):
    jp = JProblem.build(j_build_bvss(J_FAM[name]))
    tp = BlestProblem.build(build_bvss(T_FAM[name]), "cpu")
    return jp, tp


# ---------------------------------------------------------------------------
# the kernel's twin against the reference kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sigma", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("B,S", [(1, 1), (5, 3), (127, 8), (129, 9),
                                 (300, 130)])
def test_bvss_spmm_twin_matches_reference_kernel(sigma, B, S):
    """The sweep of tests/test_multi_source.py, every σ | 32: bit-31 words
    and frontier bytes with bits above σ set (random uint32)."""
    rng = np.random.default_rng(sigma * 1000 + B + S)
    masks, fb = u32(rng, (B, 32)), u32(rng, (B, S))
    want = np.asarray(j_bvss_spmm(jnp.asarray(masks), jnp.asarray(fb),
                                  sigma=sigma))
    got = bvss_spmm_ref(t32(masks), t32(fb), sigma)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (B, 32 // sigma, 32, S)
    np.testing.assert_array_equal(got.numpy(), want)
    # the entry point on CPU tensors is the twin
    np.testing.assert_array_equal(
        bvss_spmm(t32(masks), t32(fb), sigma=sigma).numpy(), want)


@pytest.mark.parametrize("sigma", [4, 8, 32])
def test_bvss_spmm_single_column_matches_pull(sigma):
    """With S = 1 the stacked SpMM reduces to the single-source pull:
    counts > 0 == hits."""
    rng = np.random.default_rng(sigma)
    masks, fb = t32(u32(rng, (77, 32))), t32(u32(rng, (77,)))
    counts = bvss_spmm_ref(masks, fb[:, None], sigma)
    assert torch.equal(counts[..., 0] > 0, bvss_pull_ref(masks, fb, sigma))


@pytest.mark.parametrize("sigma", [1, 8, 32])
@pytest.mark.parametrize("S", [1, 3, 8])
def test_wave_helpers_match_reference(sigma, S):
    """Union words, per-column frontier bytes (pull and push), and the
    per-column pack/unpack, on the same random frontier words."""
    rng = np.random.default_rng(sigma * 10 + S)
    n = 333
    n_sets = -(-n // sigma)
    n_fwords = (n_sets * sigma + 31) // 32
    F = u32(rng, (n_fwords, S))
    F[0, 0] = 0x80000001
    jF, tF = jnp.asarray(F), t32(F)
    np.testing.assert_array_equal(
        tms._union_words(tF).numpy().view(np.uint32),
        np.asarray(jms._union_words(jF)))
    sets = rng.integers(0, n_sets, 50).astype(np.int32)
    np.testing.assert_array_equal(
        _frontier_bytes(tF, torch.from_numpy(sets), sigma).numpy()
        .view(np.uint32),
        np.asarray(j_frontier_bytes(jF, jnp.asarray(sets), sigma)))
    # push bytes, the dummy vertex n_fwords * 32 (past the last word) too
    vrep = np.append(rng.integers(0, n, 40), n_fwords * 32).astype(np.int64)
    np.testing.assert_array_equal(
        tms._push_fbytes(tF, torch.from_numpy(vrep), sigma).numpy()
        .view(np.uint32)[:-1],
        np.asarray(jms._push_fbytes(jF, jnp.asarray(vrep, jnp.int32),
                                    sigma))[:-1])
    bits = rng.random((n_fwords * 32, S)) < 0.3
    packed = tms._pack_cols(torch.from_numpy(bits), n_fwords)
    np.testing.assert_array_equal(
        packed.numpy().view(np.uint32),
        np.asarray(jms._pack_cols(jnp.asarray(bits), n_fwords)))
    np.testing.assert_array_equal(tms._unpack_cols(packed).numpy(), bits)


# ---------------------------------------------------------------------------
# the fused marks' twin against the unfused counts and indexed store
# ---------------------------------------------------------------------------
def unfused_mark(masks, fb, row_ids, marks, sigma):
    """The wave engine's mark before the fusion: ``bvss_spmm_ref``'s
    counts, then one ``index_put_`` of every (slice, column) cell, misses
    to the sink row L = ``marks.shape[0] - 1``."""
    L, S = marks.shape[0] - 1, marks.shape[1]
    rows = row_ids.reshape(-1)
    hit = bvss_spmm_ref(masks, fb, sigma).view(rows.shape[0], S) > 0
    tgt = torch.where(hit, rows[:, None], L)
    marks.index_put_((tgt, torch.arange(S)), torch.ones((), dtype=torch.uint8))
    return marks


@pytest.mark.parametrize("sigma", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("S", [1, 3, 4, 8, 64])
def test_bvss_spmm_mark_twin_equals_unfused_mark(sigma, S):
    """Ragged B, all-zero dummy VSSs, padding slices mapped to the sink,
    rows hit from two VSSs, bits above σ in the frontier bytes, and marks
    already set before the call: the fused twin stores 1 at exactly the
    hit cells (nothing on a miss) and equals the unfused mark on every
    row but the sink; the entry on CPU tensors is the twin."""
    rng = np.random.default_rng(sigma * 100 + S)
    B, L, spw = 37, 50, 32 // sigma
    masks = t32(u32(rng, (B, 32)))
    masks[[3, 17, 36]] = 0                        # dummy VSSs
    fb = t32(u32(rng, (B, S)))
    row_ids = torch.from_numpy(
        rng.integers(0, L, (B, spw, 32)).astype(np.int32))
    row_ids[5, :, 20:] = L                        # padding slices: the sink
    row_ids[9] = row_ids[8]                       # every row of 8 again
    masks[9] = masks[8]
    fb[8:10] = -1                                 # every bit: hits in 8, 9
    start = torch.from_numpy((rng.random((L + 1, S)) < 0.1).astype(np.uint8))
    got = bvss_spmm_mark_ref(masks, fb, row_ids, start.clone(), sigma)
    want = unfused_mark(masks, fb, row_ids, start.clone(), sigma)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (L + 1, S)
    assert torch.equal(got[:L], want[:L])
    # the hit cells alone, from the counts
    hit = bvss_spmm_ref(masks, fb, sigma) > 0
    b, j, l, s = hit.nonzero(as_tuple=True)
    only = torch.zeros_like(start)
    only[row_ids[b, j, l].long(), s] = 1
    assert torch.equal(got, start | only)
    assert hit[8].any() and torch.equal(hit[8], hit[9])
    marks = start.clone()
    assert bvss_spmm_mark(masks, fb, row_ids, marks, sigma=sigma) is marks
    assert torch.equal(marks, got)


def test_engine_takes_the_fused_marks_without_a_seam(monkeypatch):
    """Without ``spmm_impl`` every level, pull and push, marks through
    ``bvss_spmm_mark``; with a seam every level goes through the seam and
    the fused entry is never called."""
    calls = {"mark": 0, "seam": 0}

    def spy_mark(*args, **kw):
        calls["mark"] += 1
        return bvss_spmm_mark_ref(*args, **kw)

    def seam(*args, **kw):
        calls["seam"] += 1
        return bvss_spmm_ref(*args, **kw)

    monkeypatch.setattr(tms, "bvss_spmm_mark_ref", spy_mark)
    _, tp = problems("flip")
    srcs = np.array([0, 5, 1500])
    for impl in (None, seam):
        eng = tms.make_ms_engine(tp, 3, use_kernel=False, spmm_impl=impl)
        st = eng.init(srcs)
        while st.cont:
            st, _ = eng.level_step(st)
        levels = eng.stats["pull_levels"] + eng.stats["push_levels"]
        assert eng.stats["pull_levels"] > 0 and eng.stats["push_levels"] > 0
        assert calls == ({"mark": levels, "seam": 0} if impl is None
                         else {"mark": levels, "seam": levels})
        for i, s in enumerate(srcs):
            np.testing.assert_array_equal(eng.levels_of(st, i).numpy(),
                                          reference_bfs(T_FAM["flip"], s))


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
@pytest.mark.parametrize("name", ["rmat", "flip"])
def test_fused_marks_equal_seam(name, direction):
    """The engine with its marks fused and the same engine built with
    ``spmm_impl=bvss_spmm_ref`` give equal levels, through
    ``make_multi_source_bfs`` and through ``drive_wave``."""
    _, tp = problems(name)
    queries = [0, 5, 19, 64, 100, 5, 127]
    tm.check_fused_and_seam(tm.fused_and_seam(tp, direction, queries),
                            T_FAM[name], queries, direction)


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
def test_levels_batch_on_fused_marks_equals_reference_bfs(direction):
    """``GraphSession.levels_batch`` on the fused path: refills and a
    duplicate, each answer equal to the host BFS."""
    g = T_FAM["flip"]
    sess = rt.GraphSession(g, max_batch=4, options=rt.PrepareOptions(
        device="cpu", direction=direction))
    queries = [0, 1111, g.n - 1, 7, 1200, 0]
    for q, lv in zip(queries, sess.levels_batch(queries)):
        np.testing.assert_array_equal(lv, reference_bfs(g, q))
    wave = sess.counters()["wave"]
    assert wave["pull_levels"] + wave["push_levels"] > 0


# ---------------------------------------------------------------------------
# the fixed-cohort engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_multi_source_matches_reference(name):
    """tests/test_multi_source.py::test_multi_source_oracle_agreement on
    both packages: the reference with its interpret-mode kernel."""
    jg, tg = J_FAM[name], T_FAM[name]
    srcs = np.random.default_rng(7).integers(0, tg.n, 5).astype(np.int32)
    want = np.asarray(jms.make_multi_source_bfs(jg, 5)(jnp.asarray(srcs)))
    got = tms.make_multi_source_bfs(tg, 5, device="cpu")(srcs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (tg.n, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(got[:, i].numpy(),
                                      reference_bfs(tg, int(s)))


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
@pytest.mark.parametrize("name", ["rmat", "grid", "flip"])
def test_multi_source_directions_match_reference(name, direction):
    """The direction sweep of tests/test_hybrid.py (the reference on its
    jnp path, as there).  On "flip" auto takes both branches."""
    jg, tg = J_FAM[name], T_FAM[name]
    srcs = np.array([0, tg.n // 3, tg.n // 2, tg.n - 1], dtype=np.int32)
    want = np.asarray(jms.make_multi_source_bfs(
        jg, 4, use_kernel=False, direction=direction)(jnp.asarray(srcs)))
    f = tms.make_multi_source_bfs(tg, 4, direction=direction, device="cpu")
    np.testing.assert_array_equal(f(srcs).numpy(), want)
    stats = f.engine.stats
    assert stats["push_levels"] > 0 or direction != "push"
    assert stats["pull_levels"] > 0 or direction != "pull"
    if name == "flip" and direction == "auto":
        assert stats["push_levels"] > 0 and stats["pull_levels"] > 0
    # one host copy per level plus the initial requeue
    assert stats["host_syncs"] == \
        stats["push_levels"] + stats["pull_levels"] + 1


def test_multi_source_duplicate_and_isolated_sources():
    g = T_FAM["disconnected"]
    lv = tms.make_multi_source_bfs(g, 3, device="cpu")(
        np.array([1, 1, 40])).numpy()
    np.testing.assert_array_equal(lv[:, 0], lv[:, 1])
    want = np.full(50, INF, dtype=np.int32)
    want[40] = 0
    np.testing.assert_array_equal(lv[:, 2], want)


def test_kernel_entry_and_twin_paths_agree():
    g = tgen.rmat(8, 6, seed=3)
    srcs = np.array([0, 9, 100, 255])
    a = tms.make_multi_source_bfs(g, 4, use_kernel=True, device="cpu")(srcs)
    b = tms.make_multi_source_bfs(g, 4, use_kernel=False, device="cpu")(srcs)
    assert torch.equal(a, b)
    c = make_engine(g, "multi_source", n_sources=4, device="cpu")(srcs)
    assert torch.equal(a, c)


def test_max_levels_stops_early():
    g = T_FAM["grid"]
    srcs = np.array([0, 100])
    cut = tms.make_multi_source_bfs(g, 2, max_levels=3, device="cpu")(
        srcs).numpy()
    for i, s in enumerate(srcs):
        full = reference_bfs(g, int(s))
        np.testing.assert_array_equal(cut[:, i], np.where(full <= 3, full,
                                                          INF))


# ---------------------------------------------------------------------------
# the engine surface and the wave driver
# ---------------------------------------------------------------------------
def test_engine_surface_matches_reference_level_by_level():
    """init, level_step, insert + requeue, col_live and levels_of, the
    state compared after every level."""
    jp, tp = problems("flip")
    je = jms.make_ms_engine(jp, 3)
    te = tms.make_ms_engine(tp, 3)
    srcs = np.array([5, 9, 1500])
    js, ts = je.init(jnp.asarray(srcs, jnp.int32)), te.init(srcs)
    n = tp.n
    for lvl in range(12):
        if lvl == 4:    # refill slot 1 mid-flight
            js = je.requeue(je.insert(js, 1, 77))
            ts = te.requeue(te.insert(ts, 1, 77))
        js, jlive = je.level_step(js)
        ts, tlive = te.level_step(ts)
        np.testing.assert_array_equal(tlive, np.asarray(jlive))
        np.testing.assert_array_equal(te.col_live(ts), np.asarray(jlive))
        np.testing.assert_array_equal(ts.levels[:n].numpy(),
                                      np.asarray(js.levels)[:n])
        np.testing.assert_array_equal(ts.F.numpy().view(np.uint32),
                                      np.asarray(js.F))
        assert ts.count == int(js.count) and ts.cont == bool(js.cont)
        np.testing.assert_array_equal(ts.col_lvl.numpy(),
                                      np.asarray(js.col_lvl))
        np.testing.assert_array_equal(te.levels_of(ts, 2).numpy(),
                                      np.asarray(je.levels_of(js, 2)))


def _drive(mod, eng, pending, harvest_at=None):
    """Serve ``pending`` through ``mod.drive_wave``; with ``harvest_at =
    (src, offers)``, that query is harvested at its offers-th offer."""
    pending = list(pending)
    owner, results, partial, offers = {}, {}, {}, []

    def next_source(slot):
        if not pending:
            return None
        owner[slot] = pending.pop()
        return owner[slot]

    def on_converged(slot, lv):
        results[owner[slot]] = np.asarray(lv)

    def should_harvest(slot):
        offers.append(owner[slot])
        return (owner[slot] == harvest_at[0]
                and offers.count(owner[slot]) == harvest_at[1])

    def on_harvested(slot, lv):
        partial[owner[slot]] = np.asarray(lv)

    hooks = {} if harvest_at is None else dict(
        should_harvest=should_harvest, on_harvested=on_harvested)
    steps = mod.drive_wave(eng, next_source, on_converged,
                           max_steps=10 * eng.problem.n, **hooks)
    return steps, results, partial, offers


@pytest.mark.parametrize("harvest", [False, True])
def test_drive_wave_matches_reference(harvest):
    """More queries than slots (refills), a duplicate, an isolated source,
    and optionally one query harvested mid-flight: the same levels run,
    the same answers, the same partial levels and the same offers."""
    jp, tp = problems("rmat")
    pending = [1, 5, 9, 33, 50, 5, 255]
    harvest_at = (9, 2) if harvest else None
    want = _drive(jms, jms.make_ms_engine(jp, 3), pending, harvest_at)
    eng = tms.make_ms_engine(tp, 3)
    got = _drive(tms, eng, pending, harvest_at)
    assert got[0] == want[0]
    for mine, theirs in zip(got[1:3], want[1:3]):
        assert mine.keys() == theirs.keys()
        for s in mine:
            np.testing.assert_array_equal(mine[s], theirs[s])
    assert got[3] == want[3]
    for s, lv in got[1].items():
        np.testing.assert_array_equal(lv, reference_bfs(T_FAM["rmat"], s))
    if harvest:
        assert 9 in got[2] and 9 not in got[1]
        assert (got[2][9] == INF).any()
    assert eng.stats["host_syncs"] >= got[0]


def test_drive_wave_non_convergence_guard():
    _, tp = problems("grid")
    queue = [0, 1]
    with pytest.raises(RuntimeError, match="did not converge"):
        tms.drive_wave(tms.make_ms_engine(tp, 2),
                       lambda slot: queue.pop() if queue else None,
                       lambda slot, lv: None, max_steps=0)


def test_unported_and_invalid_options_raise():
    _, tp = problems("rmat")
    with pytest.raises(ConfigError, match="pull-only"):
        tms.make_ms_engine(tp, 2, track_sigma=True, direction="push")
    with pytest.raises(ConfigError, match="direction"):
        tms.make_ms_engine(tp, 2, direction="sideways")
    with pytest.raises(ConfigError, match="3 sources"):
        tms.make_ms_engine(tp, 3).init(np.array([0, 1]))
    # the reference ignores these on a single device, and so does the port
    # (spmm_w_impl is used only by the σ channel)
    eng = tms.make_ms_engine(tp, 2, spmm_w_impl=lambda *a: None,
                             gather_impl=lambda *a: None,
                             push_impl=lambda *a: None)
    assert eng.n_slots == 2
