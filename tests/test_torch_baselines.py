"""The paper's Table-2 engines of the PyTorch port against the JAX
reference, on the CPU.

The same numpy-made graphs go through ``repro.core.make_engine`` and
``repro_torch.core.bfs.make_engine(..., device="cpu")`` for each of the
seven ``ENGINES`` (levels are integers, so they must be equal), and
through both packages' ``prepare`` with an explicit engine, ordered and
not.  The dense pieces are held against the reference too: the packed
pull adjacency ``to_dense_bits`` byte for byte, the twins of ``bit_spmm``
and ``finalize_sweep`` against the Pallas kernels (interpret mode, as
``tests/test_kernels.py`` runs them), and the dense multi-source baseline
against ``benchmarks/bench_service.py``'s."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
import repro.kernels as jk
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro.graphs import to_dense_bits as j_to_dense_bits
from repro.kernels import ref as jref
import repro_torch
import repro_torch.core.bfs as tbfs
import repro_torch.kernels as tk
from repro_torch.bench.bench_service import make_dense_multi_source_bfs
from repro_torch.core.policy import BVSS_ENGINES
from repro_torch.errors import ConfigError, GraphValidationError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import to_dense_bits
from repro_torch.kernels import ref as tref


sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks.bench_service import (  # noqa: E402
    make_dense_multi_source_bfs as j_make_dense_multi_source_bfs)
from torch_one_thread import one_torch_thread  # noqa: E402, F401

INF = np.iinfo(np.int32).max


def families(gen, from_edges):
    """tests/test_bfs_engines.py's FAMILIES, plus a vertex with no edge at
    all (sources 0 and 50) and a one-vertex graph."""
    return {
        "rmat": gen.rmat(8, 8, seed=1),
        "grid": gen.grid2d(17, 19),
        "star": gen.star(97),
        "er": gen.erdos_renyi(300, 3.0, seed=2),
        "path": gen.path(64),
        "disconnected": from_edges(50, np.array([1, 2, 10]),
                                   np.array([2, 3, 11])),
        "isolated_source": from_edges(51, np.array([1, 2, 10, 20]),
                                      np.array([2, 3, 11, 21])),
        "single_vertex": gen.path(1),
    }


J_FAM = families(jgen, j_from_edges)
T_FAM = families(tgen, t_from_edges)


def sources(n):
    return sorted({0, n // 2, n - 1})


def test_engine_list_matches_reference():
    assert tbfs.ENGINES == jcore.ENGINES
    assert tbfs.MULTI_ENGINES == jcore.bfs.MULTI_ENGINES
    assert BVSS_ENGINES == repro.core.policy.BVSS_ENGINES


@pytest.mark.parametrize("engine", jcore.ENGINES)
@pytest.mark.parametrize("gname", sorted(J_FAM))
def test_engine_matches_reference(engine, gname):
    jg, tg = J_FAM[gname], T_FAM[gname]
    jf = jcore.make_engine(jg, engine)
    tf = tbfs.make_engine(tg, engine, device="cpu")
    for src in sources(tg.n):
        want = np.asarray(jf(src))
        got = tf(src)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"source {src}")
    if gname == "isolated_source":
        lv = tf(0).numpy()
        assert lv[0] == 0 and (lv[1:] == INF).all()


@pytest.mark.parametrize("order", [False, True])
@pytest.mark.parametrize("engine", jcore.ENGINES)
def test_prepare_engine_and_order_match_reference(engine, order):
    jg, tg = jgen.clustered(6, 32, seed=4), tgen.clustered(6, 32, seed=4)
    jp = repro.prepare(jg, options=repro.PrepareOptions(engine=engine,
                                                        order=order))
    tp = repro_torch.prepare(tg, options=repro_torch.PrepareOptions(
        engine=engine, order=order, device="cpu"))
    assert tp.engine_name == jp.engine_name == engine
    assert tp.ordering == jp.ordering
    np.testing.assert_array_equal(tp.perm, jp.perm)
    assert (tp.problem is None) == (jp.problem is None)
    assert (tp.problem is None) == (engine not in BVSS_ENGINES)
    assert tp.device.type == "cpu"
    for s in (0, 77, tg.n - 1):
        np.testing.assert_array_equal(tp.levels(s), jp.levels(s))


def test_session_over_a_csr_engine_builds_its_own_problem():
    """A CSR engine override prepares no device BVSS; the wave pool of a
    GraphSession still serves (the reference builds it session-local)."""
    g = tgen.grid2d(9, 11)
    sess = repro_torch.GraphSession(g, max_batch=2, options=(
        repro_torch.PrepareOptions(engine="dirop", device="cpu")))
    assert sess.prepared.problem is None
    for s, lv in zip((0, 40, 98), sess.levels_batch([0, 40, 98])):
        np.testing.assert_array_equal(lv, repro_torch.reference_bfs(g, s))
    np.testing.assert_array_equal(sess.levels(40),
                                  repro_torch.reference_bfs(g, 40))


def test_brs_pulls_through_the_kernel_entry_point(monkeypatch):
    """BRS pulls every VSS each level through ``pull_vss_kernel`` (the CUDA
    ``bvss_pull`` on a card; the reference pulls BRS with its jnp pull)."""
    calls = []

    def spy(masks, fbytes, sigma):
        calls.append(masks.shape[0])
        return tk.pull_vss_kernel(masks, fbytes, sigma)

    monkeypatch.setattr(tbfs, "pull_vss_kernel", spy)
    g = T_FAM["grid"]
    problem = tbfs.BlestProblem.build(tbfs.build_bvss(g), "cpu")
    lv = tbfs.make_brs_bfs(problem)(0).numpy()
    np.testing.assert_array_equal(lv, repro_torch.reference_bfs(g, 0))
    depth = int(lv.max())
    # every level sweeps all VSSs; the last one finds no new vertex
    assert calls == [problem.num_vss] * (depth + 1)


def test_brs_twin_path_and_max_levels():
    g = T_FAM["rmat"]
    problem = tbfs.BlestProblem.build(tbfs.build_bvss(g), "cpu")
    full = repro_torch.reference_bfs(g, 3)
    np.testing.assert_array_equal(
        tbfs.make_brs_bfs(problem, use_kernels=False)(3).numpy(), full)
    cut = tbfs.make_brs_bfs(problem, max_levels=2)(3).numpy()
    np.testing.assert_array_equal(cut, np.where(full <= 2, full, INF))


@pytest.mark.parametrize("mode", ["push", "pull", "dirop"])
def test_csr_max_levels_and_bad_mode(mode):
    g = T_FAM["grid"]
    full = repro_torch.reference_bfs(g, 0)
    cut = tbfs.make_csr_bfs(g, mode, max_levels=4, device="cpu")(0).numpy()
    np.testing.assert_array_equal(cut, np.where(full <= 4, full, INF))
    with pytest.raises(GraphValidationError):
        tbfs.make_csr_bfs(g, "sideways", device="cpu")


def test_unknown_engine_raises():
    with pytest.raises(ConfigError, match="unknown engine"):
        tbfs.make_engine(T_FAM["grid"], "bfs_gpu", device="cpu")


@pytest.mark.parametrize("gname", sorted(J_FAM))
def test_to_dense_bits_byte_equal(gname):
    want = j_to_dense_bits(J_FAM[gname])
    got = to_dense_bits(T_FAM[gname])
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def t32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("R,C,S", [(8, 40, 3), (128, 128, 128),
                                   (200, 300, 70), (1, 32, 1),
                                   (130, 260, 129)])
def test_bit_spmm_twin_equals_pallas(R, C, S, signed):
    """tests/test_kernels.py's sweep; the last word keeps its bits beyond C
    (they must count nothing) and ``signed`` draws X over all of int8."""
    rng = np.random.default_rng(R * 1000 + C + S + signed)
    W = (C + 31) // 32
    a = u32(rng, (R, W))
    a[::3, -1] |= np.uint32(0x80000000)
    lo = -128 if signed else 0
    hi = 128 if signed else 2
    x = rng.integers(lo, hi, (C, S)).astype(np.int8)
    want = np.asarray(jk.bit_spmm(jnp.asarray(a), jnp.asarray(x)))
    np.testing.assert_array_equal(
        want, np.asarray(jref.bit_spmm_ref(jnp.asarray(a), jnp.asarray(x))))
    got = tk.bit_spmm(t32(a), torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (R, S)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.bit_spmm_ref(t32(a), torch.from_numpy(x)).numpy(), want)


def test_kernel_wrappers_validate_operands(monkeypatch):
    """Operands the dispatch sends to a kernel (simulated here) are checked
    before any pointer goes to C."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "use_kernel", lambda *tensors: True)
    with pytest.raises(ConfigError, match="fewer than"):
        tk.bit_spmm(torch.zeros((2, 1), dtype=torch.int32),
                    torch.zeros((33, 1), dtype=torch.int8))
    with pytest.raises(ConfigError, match="int8"):
        tk.bit_spmm(torch.zeros((2, 1), dtype=torch.int32),
                    torch.zeros((32, 1), dtype=torch.int32))
    with pytest.raises(ConfigError, match="uint8"):
        tk.finalize_sweep(torch.zeros(5, dtype=torch.bool),
                          torch.zeros(5, dtype=torch.int32), 1)


@pytest.mark.parametrize("N", [1, 31, 33, 1000, 4097])
def test_finalize_sweep_twin_equals_pallas(N):
    rng = np.random.default_rng(N)
    lvl = 9
    marks = rng.integers(0, 3, N).astype(np.uint8)
    levels = np.where(rng.random(N) < 0.5, np.int32(INF),
                      rng.integers(0, lvl, N).astype(np.int32))
    jl, jn = jk.finalize_sweep(jnp.asarray(marks), jnp.asarray(levels), lvl)
    tl, tn = tk.finalize_sweep(torch.from_numpy(marks),
                               torch.from_numpy(levels), lvl)
    assert tl.dtype == torch.int32 and tn.dtype == torch.bool
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    wl, wn = jref.finalize_sweep_ref(jnp.asarray(marks), jnp.asarray(levels),
                                     lvl)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(wn))


@pytest.mark.parametrize("n_sources", [4, 8])
@pytest.mark.parametrize("gname", ["rmat", "grid", "disconnected",
                                   "single_vertex"])
def test_dense_multi_source_matches_reference(gname, n_sources):
    """4 fixed sources with a repeat, or 8 drawn from a seed (the smoke's
    cohort width)."""
    jg, tg = J_FAM[gname], T_FAM[gname]
    if n_sources == 4:
        srcs = np.array([0, tg.n // 2, tg.n - 1, 0], dtype=np.int32)
    else:
        srcs = np.random.default_rng(8).integers(
            0, tg.n, n_sources).astype(np.int32)
    want = np.asarray(j_make_dense_multi_source_bfs(jg, len(srcs))(
        jnp.asarray(srcs)))
    got = make_dense_multi_source_bfs(tg, len(srcs), device="cpu")(srcs)
    assert got.dtype == torch.int32 and got.shape == (tg.n, len(srcs))
    np.testing.assert_array_equal(got.numpy(), want)
