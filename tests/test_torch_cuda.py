"""The port's CUDA kernels against their PyTorch twins, and the BFS, wave
and verb entry points against the host oracles, on the card.

These cases need a CUDA card and skip without one: the hand-written
kernels are CUDA C++ with no CPU mode.  The file imports only the port, so
it runs on a machine without JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel and twin must be equal: the integer and bool outputs trivially,
the float tiles because each kernel adds (or takes the min) in its twin's
order.  The float-channel verbs hold against the host oracles at the
reference tests' tolerances (betweenness rtol 1e-4, atol 1e-4; PageRank
relative error 1e-6; SSSP with dyadic weights exactly)."""
import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.kernels as tk
from repro_torch.kernels import ref as tref
from torch_one_thread import one_torch_thread  # noqa: F401

SIGMAS = (1, 2, 4, 8, 16, 32)
INF = np.int32(np.iinfo(np.int32).max)


def u32(rng, shape):
    """Random uint32 words with all-ones and bit-31-only words mixed in."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[::7] = 0xFFFFFFFF
    flat[3::11] = 0x80000000
    return w


def t32(words: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 carrier, bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_pull_push_equal_twins(cuda_device, sigma):
    rng = np.random.default_rng(sigma + 100)
    for B in (1, 127, 1003, 4099):
        masks = t32(u32(rng, (B, 32))).to(cuda_device)
        fb = t32(u32(rng, (B,))).to(cuda_device)
        bits = torch.from_numpy(
            rng.integers(0, sigma, B).astype(np.int32)).to(cuda_device)
        before = tk.launch_counts()
        got_pull = tk.bvss_pull(masks, fb, sigma=sigma)
        got_push = tk.bvss_push(masks, bits, sigma=sigma)
        torch.cuda.synchronize()
        after = tk.launch_counts()
        assert after["bvss_pull"] == before["bvss_pull"] + 1
        assert after["bvss_push"] == before["bvss_push"] + 1
        assert torch.equal(got_pull, tref.bvss_pull_ref(masks, fb, sigma))
        assert torch.equal(got_push, tref.bvss_push_ref(masks, bits, sigma))


SPMM_S = (1, 2, 3, 4, 5, 8, 9, 16, 64, 128)


def spmm_case(rng, device, B, S, sigma, offset=0):
    """One ``bvss_spmm`` call against its twin: one launch, equal output.
    ``offset`` > 0 puts ``fbytes`` at that storage offset, so its rows are
    not 16-byte aligned (the kernel's 4-byte frontier loads)."""
    masks = t32(u32(rng, (B, 32))).to(device)
    flat = t32(u32(rng, (B * S + offset,))).to(device)
    fb = flat[offset:].view(B, S)
    before = tk.launch_counts()["bvss_spmm"]
    got = tk.bvss_spmm(masks, fb, sigma=sigma)
    torch.cuda.synchronize()
    assert tk.launch_counts()["bvss_spmm"] == before + 1
    assert torch.equal(got, tref.bvss_spmm_ref(masks, fb, sigma)), \
        (B, S, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_spmm_equals_twin(cuda_device, sigma):
    """Ragged B and S (the 16-byte store path at S in {4, 8, ..., 128},
    the scalar path otherwise), bit-31 words, frontier bytes with bits
    above σ set."""
    rng = np.random.default_rng(sigma + 200)
    for B in (1, 127, 1003):
        for S in SPMM_S:
            spmm_case(rng, cuda_device, B, S, sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_spmm_long_queue_equals_twin(cuda_device, sigma):
    """B = 65,537 VSSs, one past the grid wave's queue: more blocks than
    the card holds at once, the last block with one live warp; both store
    paths."""
    rng = np.random.default_rng(sigma + 250)
    for S in (1, 8, 9):
        spmm_case(rng, cuda_device, 65_537, S, sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_spmm_misaligned_frontier_equals_twin(cuda_device, sigma):
    """``fbytes`` at a storage offset of 1: rows not 16-byte aligned, on
    both store paths."""
    rng = np.random.default_rng(sigma + 270)
    for B in (127, 1003):
        for S in (3, 4, 8, 128):
            spmm_case(rng, cuda_device, B, S, sigma, offset=1)


def finalize_case(rng, device, N, sigma, lazy, *, pad=0, offset=0):
    """One ``finalize_pack_sweep`` call against its twin: one launch, equal
    outputs.  ``pad`` extra words and sets give ``n_fwords·32 > N`` and
    ``n_sets·σ > N`` beyond the minimum; ``offset`` puts levels and marks
    at that storage offset (views the kernel takes one vertex at a time)."""
    lvl = 5
    levels = torch.from_numpy(rng.choice(
        np.array([INF, lvl, 2, 0], np.int32), N + offset)).to(device)[offset:]
    marks = (torch.from_numpy(rng.integers(0, 3, N + offset).astype(
        np.uint8)).to(device)[offset:] if lazy else None)
    n_sets = -(-N // sigma) + pad
    kw = dict(sigma=sigma, n_fwords=(n_sets * sigma + 31) // 32 + pad,
              n_sets=n_sets, marks=marks)
    before = tk.launch_counts()["finalize_pack_sweep"]
    got = tk.finalize_pack_sweep(levels, lvl, **kw)
    want = tref.finalize_pack_ref(levels, lvl, **kw)
    torch.cuda.synchronize()
    assert tk.launch_counts()["finalize_pack_sweep"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (N, pad, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_finalize_equals_twin(cuda_device, sigma, lazy):
    """Ragged N around the 128-vertex warp pass and the 256-vertex step of
    two passes, up to one past the grid's 4,194,304 vertices."""
    rng = np.random.default_rng(sigma * 3 + lazy)
    for N in (1, 31, 33, 127, 128, 129, 1000, 4095, 70_001, 4_194_305):
        finalize_case(rng, cuda_device, N, sigma, lazy)


@pytest.mark.cuda
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_finalize_padding_and_views_equal_twin(cuda_device, sigma,
                                                    lazy):
    """``n_fwords·32 > N`` and ``n_sets·σ > N`` past the minimum (words and
    flags of vertices that are never new), and ``levels[1:]`` /
    ``marks[1:]`` views that take the one-vertex path."""
    rng = np.random.default_rng(sigma * 5 + lazy + 50)
    for N in (1, 129, 4095, 70_001):
        finalize_case(rng, cuda_device, N, sigma, lazy, pad=3)
        finalize_case(rng, cuda_device, N, sigma, lazy, offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
@pytest.mark.parametrize("engine", ["blest", "blest_lazy"])
def test_cuda_bfs_equals_oracle(cuda_device, engine, direction):
    """The entry point on the card, both engines and every direction:
    levels equal to the host oracle, each kernel the step can reach
    launched.  The planted-partition graph in its natural order is the
    setting of tests/test_hybrid.py in which auto mode takes both
    branches."""
    g = repro_torch.generators.clustered(40, 60, p_in=0.4, seed=1)
    tk.reset_launch_counts()
    p = repro_torch.prepare(g, engine=engine, direction=direction,
                            order=False)
    assert p.device.type == "cuda"
    for s in (0, 1111, g.n - 1):
        np.testing.assert_array_equal(p.levels(s),
                                      repro_torch.reference_bfs(g, s))
    counts = tk.launch_counts()
    assert counts["finalize_pack_sweep"] > 0, counts
    assert (counts["bvss_pull"] > 0) == (direction != "push"), counts
    # one finalize sweep a level; a push level is one bvss_push_level
    # launch, and the unfused bvss_push is not on this path
    push_levels = counts["finalize_pack_sweep"] - counts["bvss_pull"]
    assert counts["bvss_push_level"] == push_levels, counts
    assert (push_levels > 0) == (direction != "pull"), counts
    assert counts["bvss_push"] == 0, counts


def push_level_problem(name, sigma, device):
    """The CPU push-level tests' graphs, on the card: ``grid_isolated`` is
    grid2d(20, 20) with 40 edgeless vertices after it (empty slice sets;
    R = 1 up to σ = 16), ``clustered`` the planted partition (R >= 2 from
    σ = 8)."""
    from repro_torch.core.bfs import BlestProblem
    from repro_torch.core.bvss import build_bvss
    from repro_torch.graphs import from_edges, src_of_edges
    gen = repro_torch.generators
    if name == "grid_isolated":
        g = gen.grid2d(20, 20)
        g = from_edges(g.n + 40, src_of_edges(g), g.indices)
    else:
        g = gen.clustered(40, 60, p_in=0.4, seed=1)
    return BlestProblem.build(build_bvss(g, sigma=sigma), device)


@pytest.mark.cuda
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("name", ["grid_isolated", "clustered"])
def test_cuda_push_level_equals_twin(cuda_device, name, sigma, lazy):
    """bvss_push_level against its twin on frontiers of one vertex, of the
    auto cap's 128 vertices and of 300 (a forced push), the last two with
    the graph's last vertex (an empty slice set on the grid); levels mix
    INF with levels below, at and above lvl, marks hold stale values.
    Both whole arrays equal, slot n included; every call one launch."""
    p = push_level_problem(name, sigma, cuda_device)
    dev = p.dev
    rng = np.random.default_rng(500 + 2 * sigma + lazy)
    lvl = 5
    for size in (1, 128, 300):
        verts = (np.array([p.n // 3]) if size == 1 else np.append(
            rng.choice(p.n - 1, size - 1, replace=False), p.n - 1))
        bits = torch.zeros(p.n_fwords * 32, dtype=torch.bool)
        bits[torch.from_numpy(verts)] = True
        F = tref.pack_words(bits).to(cuda_device)
        if lazy:
            out = torch.from_numpy(rng.integers(0, 3, p.n + 1).astype(
                np.uint8)).to(cuda_device)
        else:
            out = torch.from_numpy(rng.choice(
                np.array([INF, 2, lvl - 1, lvl, lvl + 2], np.int32),
                p.n + 1)).to(cuda_device)
        key = "marks" if lazy else "levels"
        want = out.clone()
        operands = (F, dev.vss_of_vertex_start, dev.vss_of_vertex_end,
                    dev.masks, dev.row_ids, lvl)
        before = tk.launch_counts()["bvss_push_level"]
        got = tk.bvss_push_level(*operands, sigma=sigma, **{key: out})
        torch.cuda.synchronize()
        assert got is out
        assert tk.launch_counts()["bvss_push_level"] == before + 1
        tref.bvss_push_level_ref(*operands, sigma, **{key: want})
        assert torch.equal(got, want), (size, lazy)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
def test_cuda_levels_batch_equals_oracle(cuda_device, direction):
    """Wave serving on the card: more queries than slots, a duplicate,
    every direction; each answer equal to the host oracle, every level
    through the bvss_spmm kernel.  On this graph auto takes both branches."""
    g = repro_torch.generators.clustered(40, 60, p_in=0.4, seed=1)
    sess = repro_torch.GraphSession(g, max_batch=4, direction=direction,
                                    order=False)
    queries = [0, 1111, g.n - 1, 7, 1200, 0]
    tk.reset_launch_counts()
    for q, lv in zip(queries, sess.levels_batch(queries)):
        np.testing.assert_array_equal(lv, repro_torch.reference_bfs(g, q))
    stats = sess._ms.stats
    levels_run = stats["pull_levels"] + stats["push_levels"]
    assert tk.launch_counts()["bvss_spmm"] == levels_run > 0
    if direction == "auto":
        assert stats["pull_levels"] > 0 and stats["push_levels"] > 0


@pytest.mark.cuda
def test_cuda_wave_verbs_equal_oracles(cuda_device):
    """components, eccentricity_batch and closeness_batch on the card
    against the SciPy oracles, in caller ids."""
    g = repro_torch.generators.rmat(9, 8, seed=1)
    sess = repro_torch.GraphSession(g, max_batch=8)
    srcs = np.random.default_rng(3).integers(0, g.n, 11)
    np.testing.assert_array_equal(sess.components(),
                                  tref.connected_components_ref(g))
    np.testing.assert_array_equal(
        sess.eccentricity_batch(srcs),
        tref.eccentricity_ref(g.symmetrized, srcs))
    np.testing.assert_allclose(sess.closeness_batch(srcs),
                               tref.closeness_ref(g, srcs), rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_float_tiles_equal_twins(cuda_device, sigma):
    """bvss_spmm_w, bvss_spmm_t and bvss_spmm_minplus: ragged B and S (the
    16-byte store path at S % 4 == 0), bit-31 words, +inf weights and
    distances; every output equal to the twin, every call one launch."""
    rng = np.random.default_rng(sigma + 300)
    spw = 32 // sigma
    for B in (1, 127, 1003):
        for S in (1, 3, 8, 9):
            masks = t32(u32(rng, (B, 32))).to(cuda_device)
            xv = torch.from_numpy(
                rng.random((B, sigma, S), dtype=np.float32)).to(cuda_device)
            hv = torch.from_numpy(
                rng.random((B, spw, 32, S), dtype=np.float32)).to(cuda_device)
            wv = rng.uniform(0.5, 4.0, (B, spw, 32, sigma)).astype(np.float32)
            wv[rng.random(wv.shape) < 0.2] = np.inf
            dv = rng.uniform(0.0, 9.0, (B, sigma, S)).astype(np.float32)
            dv[rng.random(dv.shape) < 0.3] = np.inf
            wv = torch.from_numpy(wv).to(cuda_device)
            dv = torch.from_numpy(dv).to(cuda_device)
            before = tk.launch_counts()
            got = (tk.bvss_spmm_w(masks, xv, sigma=sigma),
                   tk.bvss_spmm_t(masks, hv, sigma=sigma),
                   tk.bvss_spmm_minplus(masks, wv, dv, sigma=sigma))
            torch.cuda.synchronize()
            after = tk.launch_counts()
            for name in ("bvss_spmm_w", "bvss_spmm_t", "bvss_spmm_minplus"):
                assert after[name] == before[name] + 1
            want = (tref.bvss_spmm_w_ref(masks, xv, sigma),
                    tref.bvss_spmm_t_ref(masks, hv, sigma),
                    tref.bvss_spmm_minplus_ref(masks, wv, dv, sigma))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == torch.float32
                assert torch.equal(g, w), (B, S)


FLOAT_B = (1, 7, 8, 9, 127, 1003)           # around a block's 8 VSSs
FLOAT_S = (1, 2, 3, 4, 8, 9, 16, 32, 128)


def float_words(rng, shape):
    """:func:`u32` words with all-zero and single-bit words mixed in."""
    w = u32(rng, shape)
    flat = w.reshape(-1)
    flat[5::13] = 0
    flat[2::17] = np.uint32(1) << rng.integers(0, 32, flat[2::17].size,
                                                dtype=np.uint32)
    return w


def float_values(rng, shape):
    """Values in [0, 1) with -0.0 and subnormals mixed in, and one +inf in
    each of three VSSs (first, middle, last) when there are 16 or more:
    almost every sum stays finite, so equality still sees the adds.  No
    -inf: no sum is NaN."""
    v = rng.random(shape, dtype=np.float32)
    flat = v.reshape(-1)
    flat[::9] = -0.0
    flat[6::29] = np.float32(1e-40) * rng.random(flat[6::29].size,
                                                 dtype=np.float32)
    if shape[0] >= 16:
        per = v.reshape(shape[0], -1)
        for b in (0, shape[0] // 2, shape[0] - 1):
            per[b, rng.integers(per.shape[1])] = np.inf
    return v


def on_card(a, device, offset):
    """``a`` on the card at storage offset ``offset`` floats (1: rows off
    16-byte alignment, the kernels' 4-byte paths)."""
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.float32), a.reshape(-1)])).to(device)
    return flat[offset:].view(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_cuda_float_tiles_ragged_equal_twins(cuda_device, sigma, offset):
    """bvss_spmm_w and bvss_spmm_t through every path of their designs: B
    around a block's 8 VSSs, S = 1 (PageRank's rows path), the 16-byte
    paths (S in {4, ..., 128}), the scalar ones (other S, or values one
    float off alignment), bvss_spmm_t's column tiles (S > sigma); zero,
    single-bit and bit-31 words; -0.0, subnormal and a few +inf values.
    Every output equal to the twin bit for bit, at least 90% of them
    finite, every call one launch."""
    rng = np.random.default_rng(400 + 2 * sigma + offset)
    spw = 32 // sigma
    for B in FLOAT_B:
        for S in FLOAT_S:
            masks = t32(float_words(rng, (B, 32))).to(cuda_device)
            xv = on_card(float_values(rng, (B, sigma, S)), cuda_device,
                         offset)
            hv = on_card(float_values(rng, (B, spw, 32, S)), cuda_device,
                         offset)
            before = tk.launch_counts()
            got = (tk.bvss_spmm_w(masks, xv, sigma=sigma),
                   tk.bvss_spmm_t(masks, hv, sigma=sigma))
            torch.cuda.synchronize()
            after = tk.launch_counts()
            for name in ("bvss_spmm_w", "bvss_spmm_t"):
                assert after[name] == before[name] + 1
            want = (tref.bvss_spmm_w_ref(masks, xv, sigma),
                    tref.bvss_spmm_t_ref(masks, hv, sigma))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == torch.float32
                assert torch.isfinite(w).float().mean() >= 0.9, (B, S)
                assert torch.equal(g, w), (B, S)
                assert torch.equal(g.view(torch.int32),
                                   w.view(torch.int32)), (B, S)


@pytest.mark.cuda
def test_cuda_float_verbs_equal_oracles(cuda_device):
    """betweenness_batch, sssp_batch / sssp and pagerank on the card, in
    caller ids, against the host oracles; each through its kernels."""
    g = repro_torch.generators.rmat(9, 8, seed=1)
    rng = np.random.default_rng(5)
    w = (rng.integers(1, 128, g.m) / 32.0).astype(np.float32)
    sess = repro_torch.GraphSession(g, max_batch=4, weights=w)
    srcs = rng.integers(0, g.n, 6)
    tk.reset_launch_counts()
    np.testing.assert_allclose(sess.betweenness_batch(srcs),
                               tref.betweenness_ref(g, srcs), rtol=1e-4,
                               atol=1e-4)
    counts = tk.launch_counts()
    for name in ("bvss_spmm", "bvss_spmm_w", "bvss_spmm_t"):
        assert counts[name] > 0, counts
    tk.reset_launch_counts()
    want = tref.sssp_ref(g, srcs, w)
    np.testing.assert_array_equal(sess.sssp_batch(srcs), want)
    np.testing.assert_array_equal(sess.sssp(int(srcs[2])), want[2])
    assert tk.launch_counts()["bvss_spmm_minplus"] > 0
    tk.reset_launch_counts()
    pr = sess.pagerank()
    ref = tref.pagerank_ref(g)
    assert np.max(np.abs(pr - ref) / ref) <= 1e-6
    assert abs(pr.sum() - 1.0) <= 1e-5
    assert tk.launch_counts()["bvss_spmm_w"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
def test_cuda_bit_spmm_equals_twin(cuda_device, signed):
    """Ragged R x C x S, bits set beyond C in every last word (they count
    nothing), X in {0, 1} or over all of int8; sums are integers, so the
    kernel equals its twin exactly."""
    rng = np.random.default_rng(300 + signed)
    for R in (1, 17, 130, 4099):
        for C in (1, 31, 33, 260, 4096):
            for S in (1, 8, 129):
                a = u32(rng, (R, (C + 31) // 32))
                a[:, -1] |= np.uint32(0x80000000)
                lo, hi = (-128, 128) if signed else (0, 2)
                x = torch.from_numpy(rng.integers(lo, hi, (C, S)).astype(
                    np.int8)).to(cuda_device)
                a = t32(a).to(cuda_device)
                before = tk.launch_counts()["bit_spmm"]
                got = tk.bit_spmm(a, x)
                torch.cuda.synchronize()
                assert tk.launch_counts()["bit_spmm"] == before + 1
                want = tref.bit_spmm_ref(a, x)
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (R, C, S)


@pytest.mark.cuda
def test_cuda_finalize_sweep_equals_twin(cuda_device):
    """Ragged N, and operands one element off 16-byte alignment (the
    kernel's one-vertex path)."""
    rng = np.random.default_rng(400)
    lvl = 6
    for N in (1, 31, 1025, 4_194_305):
        for offset in (0, 1):
            levels = torch.from_numpy(rng.choice(
                np.array([INF, lvl - 1, 2], np.int32), N + offset)).to(
                cuda_device)[offset:]
            marks = torch.from_numpy(rng.integers(0, 3, N + offset).astype(
                np.uint8)).to(cuda_device)[offset:]
            got = tk.finalize_sweep(marks, levels, lvl)
            want = tref.finalize_sweep_ref(marks, levels, lvl)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (N, offset)


@pytest.mark.cuda
def test_cuda_baselines_equal_oracle(cuda_device):
    """Every Table-2 engine on the card equals the host oracle; BRS pulls
    through ``bvss_pull``; the dense multi-source baseline (``bit_spmm``)
    equals the BVSS multi-source engine."""
    from repro_torch.bench.bench_service import make_dense_multi_source_bfs
    from repro_torch.core.bfs import ENGINES, make_engine
    from repro_torch.core.multi_source import make_multi_source_bfs
    g = repro_torch.generators.rmat(9, 8, seed=2)
    for engine in ENGINES:
        tk.reset_launch_counts()
        f = make_engine(g, engine)
        for s in (0, 7, g.n - 1):
            np.testing.assert_array_equal(f(s).cpu().numpy(),
                                          repro_torch.reference_bfs(g, s))
        if engine == "brs":
            assert tk.launch_counts()["bvss_pull"] > 0
    srcs = np.array([0, 7, 100, 7], dtype=np.int64)
    tk.reset_launch_counts()
    dense = make_dense_multi_source_bfs(g, len(srcs))(srcs)
    assert tk.launch_counts()["bit_spmm"] > 0
    bvss = make_multi_source_bfs(g, len(srcs))(srcs)
    assert torch.equal(dense, bvss)
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(dense[:, i].cpu().numpy(),
                                      repro_torch.reference_bfs(g, int(s)))


@pytest.mark.cuda
def test_cuda_analytics_cli_verifies_every_verb(cuda_device, capsys):
    """``python -m repro_torch.launch.analytics`` on the card (its default
    device): every checked verb ends ``VERIFIED`` at the reference's
    tolerances, through the four tile kernels."""
    from repro_torch.launch import analytics
    tk.reset_launch_counts()
    analytics.main(["--graph", "rmat", "--scale", "10"])
    counts = tk.launch_counts()
    lines = capsys.readouterr().out.strip().splitlines()
    assert "device=cuda" in lines[0]
    checked = [ln for ln in lines[1:] if "extremes" not in ln]
    assert len(checked) == len(analytics.WHAT) - 1
    assert all("; VERIFIED vs " in ln for ln in checked), lines
    for kernel in ("bvss_spmm", "bvss_spmm_w", "bvss_spmm_t",
                   "bvss_spmm_minplus"):
        assert counts[kernel] > 0, (kernel, counts)


@pytest.mark.cuda
def test_cuda_scale_sweep_and_fig3(cuda_device):
    """The RMAT scale sweep and Figure 3 on the card: the sweep's smallest
    scale and every Figure-3 window against the oracle, through the
    single-source kernels."""
    from repro_torch.bench import bench_scale, fig3_window
    tk.reset_launch_counts()
    out = bench_scale.run(scales=(9, 10), verbose=False)
    assert out["summary"]["all_verified"] and out["device"] == "cuda"
    assert all(so["mteps"] > 0 for so in out["scales"].values())
    rows = fig3_window.run(scale=9, verbose=False)
    assert [r.split(",")[0] for r in rows] == \
        [f"fig3/w={1 << k}" for k in range(3, 10)]
    counts = tk.launch_counts()
    assert counts["bvss_pull"] > 0 and counts["finalize_pack_sweep"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("plan,opts,kernel", [
    ("corrupt_spmm_tile", {}, "bvss_spmm"),
    ("corrupt_push_tile", {"direction": "push"}, "bvss_push"),
    ("nan_sigma", {}, "bvss_spmm_w"),
], ids=["corrupt-tile", "corrupt-push", "nan-sigma"])
def test_cuda_fault_gauntlet(cuda_device, plan, opts, kernel):
    """Each fault plan on the card: unverified, the seam around the hand
    kernel changes the answer; under full verification the session
    quarantines and every answer equals the oracle."""
    import warnings
    from repro_torch.kernels.ref import betweenness_ref
    from repro_torch.serve import (DegradedServiceWarning, FaultPlan,
                                   GraphSessionManager)
    g = repro_torch.generators.rmat(10, 8, seed=2)
    srcs = [0, 5, 19, 64]
    mgr = GraphSessionManager(verify_fraction=0.0)
    sess = mgr.open_session("s", g, max_batch=4,
                            fault_plan=FaultPlan(**{plan: True}), **opts)
    tk.reset_launch_counts()
    if plan == "nan_sigma":
        assert not np.isfinite(sess.betweenness_batch(srcs)).all()
    else:
        bad = [sess.levels(s) for s in srcs] if plan == "corrupt_push_tile" \
            else sess.levels_batch(srcs)
        assert any(not np.array_equal(lv, repro_torch.reference_bfs(g, s))
                   for s, lv in zip(srcs, bad))
    counts = tk.launch_counts()
    assert counts[kernel] > 0, counts
    if plan == "corrupt_push_tile":
        assert counts["bvss_push_level"] == 0, counts
    mgr.verify_fraction = 1.0
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        if plan == "nan_sigma":
            np.testing.assert_allclose(mgr.betweenness("s", srcs),
                                       betweenness_ref(g, srcs),
                                       rtol=1e-4, atol=1e-4)
        # singletons take the single-source engine (the push seam); the
        # wave pool carries the bit-SpMM seam
        out = [mgr.levels("s", s) for s in srcs] \
            if plan == "corrupt_push_tile" else mgr.levels_batch("s", srcs)
    for s, lv in zip(srcs, out):
        np.testing.assert_array_equal(lv, repro_torch.reference_bfs(g, s))
    assert mgr.stats()["quarantines"] == 1
    assert any(issubclass(x.category, DegradedServiceWarning) for x in w)


@pytest.mark.cuda
def test_cuda_queue_pump_equals_oracle(cuda_device):
    """The ``start()`` pump launches the kernels from its own thread while
    two threads submit: every future equals the oracle, and the launch
    count is the engine's level count (no update lost)."""
    import threading
    from repro_torch.serve import GraphSessionManager, RequestQueue
    g = repro_torch.generators.rmat(11, 8, seed=3)
    mgr = GraphSessionManager(verify_fraction=1.0)
    sess = mgr.open_session("g", g, max_batch=8)
    q = RequestQueue(mgr)
    futs = {}

    def client(lo):
        for s in range(lo, lo + 12):
            futs[s] = q.submit("g", s)

    before = dict(sess._ms.stats)
    tk.reset_launch_counts()
    q.start(poll_s=0.001)
    try:
        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in (0, 100)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
            assert not th.is_alive()
        for s, f in futs.items():
            np.testing.assert_array_equal(f.result(60.0),
                                          repro_torch.reference_bfs(g, s))
    finally:
        q.stop()
    levels = sum(sess._ms.stats[k] - before[k]
                 for k in ("pull_levels", "push_levels"))
    assert tk.launch_counts()["bvss_spmm"] == levels > 0
    assert mgr.stats()["quarantines"] == 0
    assert mgr.stats()["verified"] == 24


@pytest.mark.cuda
def test_cuda_patched_epoch_equals_oracle(cuda_device):
    """``apply_edge_updates`` on the card: the patched epoch's levels equal
    the oracle of the mutated graph through the hand kernels, and the old
    epoch's device masks keep their contents and its old answers."""
    from repro_torch.graphs import from_edges, src_of_edges
    g = repro_torch.generators.rmat(12, 8, seed=2)
    p = repro_torch.prepare(g)

    def caller_graph(prep):
        return from_edges(g.n, prep.inv[src_of_edges(prep.graph)],
                          prep.inv[prep.graph.indices])

    # inserts beside an existing edge's slice bit (no new row) and one
    # delete a slice of two or more bits (no row lost): the patched path
    rng = np.random.default_rng(3)
    src, dst = src_of_edges(p.graph), p.graph.indices.astype(np.int64)
    have = set(zip(src.tolist(), dst.tolist()))
    slice_bits = {}
    for a, b in have:
        slice_bits[(a // 8, b)] = slice_bits.get((a // 8, b), 0) + 1
    ins, dels, used = set(), set(), set()
    for i in rng.permutation(len(src)):
        a, b = int(src[i]), int(dst[i])
        a2 = (a // 8) * 8 + int(rng.integers(8))
        if len(ins) < 32 and a2 < g.n and a2 != b and (a2, b) not in have:
            ins.add((a2, b))
        elif len(dels) < 16 and slice_bits[(a // 8, b)] >= 2 and \
                (a // 8, b) not in used:
            dels.add((a, b))
            used.add((a // 8, b))
    ins = [(int(p.inv[a]), int(p.inv[b])) for a, b in sorted(ins - dels)]
    dels = [(int(p.inv[a]), int(p.inv[b])) for a, b in sorted(dels)]
    old_masks = p.problem.dev.masks.clone()
    old_want = [repro_torch.reference_bfs(g, s) for s in (0, 7)]
    p2 = repro_torch.apply_edge_updates(p, inserts=ins, deletes=dels)
    assert p2.last_update.path == "patched" and p2.epoch == 1
    assert p2.problem.dev.masks.device.type == "cuda"
    assert p2.problem.dev.masks.data_ptr() != p.problem.dev.masks.data_ptr()
    g2 = caller_graph(p2)
    tk.reset_launch_counts()
    for s in (0, 7, g.n // 2):
        np.testing.assert_array_equal(p2.levels(s),
                                      repro_torch.reference_bfs(g2, s))
    counts = tk.launch_counts()
    assert counts["bvss_pull"] > 0 and counts["finalize_pack_sweep"] > 0
    assert torch.equal(p.problem.dev.masks, old_masks)
    for s, want in zip((0, 7), old_want):
        np.testing.assert_array_equal(p.levels(s), want)


@pytest.mark.cuda
def test_cuda_autotune_cached_class_makes_no_launches(cuda_device):
    """``prepare(autotune=True)`` times the hand kernels once a class; a
    second prepare of the class times nothing and launches nothing."""
    from repro_torch.core import autotune
    autotune.clear_cache()
    g = repro_torch.generators.grid2d(64, 64)
    tk.reset_launch_counts()
    p1 = repro_torch.prepare(g, autotune=True)
    counts = tk.launch_counts()
    assert p1.tile_config.source == "tuned"
    assert counts["bvss_pull"] == counts["bvss_push"] == 6, counts
    runs, hits = autotune.stats["tune_runs"], autotune.stats["cache_hits"]
    tk.reset_launch_counts()
    p2 = repro_torch.prepare(g, autotune=True)
    assert p2.tile_config.source == "cached"
    assert autotune.stats["tune_runs"] == runs
    assert autotune.stats["cache_hits"] == hits + 1
    assert tk.launch_counts()["bvss_pull"] == 0
    assert tk.launch_counts()["bvss_push"] == 0
    np.testing.assert_array_equal(p2.levels(0),
                                  repro_torch.reference_bfs(g, 0))
    autotune.clear_cache()


@pytest.mark.cuda
def test_cuda_mesh_world_one_equals_oracle(cuda_device):
    """The mesh path on the card at world size 1 (one card holds one NCCL
    rank): the 1-D eager, lazy and BRS engines and the 2-D (1, 1) engine
    equal the oracle, and the shard's levels go through the hand kernels
    (``bvss_pull``, ``bvss_push_level``, ``finalize_pack_sweep``; 2-D:
    ``bvss_pull`` alone).  Multi-card NCCL is not exercised here."""
    import socket

    import torch.distributed as dist

    from repro_torch.distributed import bfs_mesh, bfs_mesh2d
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        g = repro_torch.generators.grid2d(256, 256)   # pushes from corners
        srcs = (0, g.n - 1)
        mesh, mesh2 = bfs_mesh(1), bfs_mesh2d(1, 1)
        for eng, kernels in (
                ("blest", ("bvss_pull", "bvss_push_level",
                           "finalize_pack_sweep")),
                ("blest_lazy", ("bvss_pull", "bvss_push_level",
                                "finalize_pack_sweep")),
                ("brs", ("bvss_pull", "finalize_pack_sweep"))):
            pb = repro_torch.prepare(g, mesh=mesh, engine=eng)
            assert pb.problem.device == torch.device("cuda", 0)
            before = tk.launch_counts()
            for s in srcs:
                np.testing.assert_array_equal(
                    pb.levels(s), repro_torch.reference_bfs(g, s))
            after = tk.launch_counts()
            for k in kernels:
                assert after[k] > before[k], (eng, k)
        pb = repro_torch.prepare(g, mesh=mesh2)
        before = tk.launch_counts()
        for s in srcs:
            np.testing.assert_array_equal(pb.levels(s),
                                          repro_torch.reference_bfs(g, s))
        after = tk.launch_counts()
        assert after["bvss_pull"] > before["bvss_pull"]
        assert after["finalize_pack_sweep"] == before["finalize_pack_sweep"]
    finally:
        dist.destroy_process_group()
