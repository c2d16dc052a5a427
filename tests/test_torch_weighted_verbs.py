"""Delta-stepping SSSP and PageRank of the PyTorch port against the JAX
reference and the host oracles, on the CPU.

SSSP uses dyadic-rational weights (k/32, as ``tests/test_weighted_verbs.py``
does): float32 path sums are then exact, so the port must equal the
reference and SciPy's float64 Dijkstra bit for bit.  PageRank is held to
the reference tests' relative error of 1e-6 and its sum to 1 within 1e-5.
The port's PageRank power iteration is held against the reference's
NetworkX oracle."""
import numpy as np
import pytest
import torch

import repro
from repro.analytics import make_pagerank as j_make_pagerank
from repro.analytics import pagerank_scores as j_pagerank_scores
from repro.analytics import sssp_distances as j_sssp_distances
from repro.core.bfs import BlestProblem as JProblem
from repro.core.bvss import build_bvss as j_build_bvss
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro.kernels.ref import pagerank_ref as j_pagerank_ref
import repro_torch
from repro_torch.analytics import (default_delta, make_pagerank, make_sssp,
                                   out_degrees, pagerank_scores,
                                   sssp_distances)
from repro_torch.analytics.sssp import _next_btop
from repro_torch.core.bfs import BlestProblem
from repro_torch.core.bvss import build_bvss
from repro_torch.errors import ConfigError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.ref import pagerank_ref, sssp_ref
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.iinfo(np.int32).max


def families(gen, from_edges):
    return {
        "rmat": gen.rmat(8, 8, seed=1),
        "grid": gen.grid2d(12, 12),
        "star": gen.star(40),
        "disc": from_edges(40, np.array([0, 1, 2, 10, 11, 20, 21]),
                           np.array([1, 2, 0, 11, 12, 21, 22])),
        "one": from_edges(1, np.array([], np.int64), np.array([], np.int64)),
        "n16": gen.rmat(4, 4, seed=2),       # n a multiple of σ: row n OOB
    }


J_FAM = families(jgen, j_from_edges)
T_FAM = families(tgen, t_from_edges)


def dyadic(rng, m):
    return (rng.integers(1, 128, m) / 32.0).astype(np.float32)


def prepared(name, weights):
    """(reference, port) weighted preparations in natural order."""
    jp = repro.prepare(J_FAM[name], options=repro.PrepareOptions(
        weights=weights, order=False))
    tp = repro_torch.prepare(T_FAM[name], device="cpu", weights=weights,
                             order=False)
    return jp, tp


# ---------------------------------------------------------------------------
# SSSP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(J_FAM))
def test_sssp_equals_reference_and_dijkstra(name):
    """5 sources through cohorts of 2 (a padded tail); unreachable
    vertices are +inf."""
    tg = T_FAM[name]
    w = dyadic(np.random.default_rng(len(name)), tg.m)
    jp, tp = prepared(name, w)
    srcs = np.random.default_rng(0).integers(0, tg.n, 5)
    got = sssp_distances(srcs, problem=tp.problem, wplane=tp.wplane,
                         weights=tp.weights, batch=2)
    want = j_sssp_distances(srcs, problem=jp.problem, wplane=jp.wplane,
                            weights=jp.weights, batch=2)
    assert got.dtype == np.float64 and got.shape == (5, tg.n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sssp_ref(tg, srcs, w))


def test_sssp_unreachable_is_inf():
    tg = T_FAM["disc"]
    _, tp = prepared("disc", np.ones(tg.m, np.float32))
    d = sssp_distances([10, 39], problem=tp.problem, wplane=tp.wplane,
                       weights=tp.weights)
    np.testing.assert_array_equal(d[0, [10, 11, 12]], [0.0, 1.0, 2.0])
    assert np.isinf(np.delete(d[0], [10, 11, 12])).all()
    assert d[1, 39] == 0.0 and np.isinf(np.delete(d[1], 39)).all()


@pytest.mark.parametrize("delta", [0.03125, 0.3, 1.0, 7.5, 1e4])
def test_sssp_delta_choice_never_changes_answers(delta):
    tg = T_FAM["rmat"]
    w = dyadic(np.random.default_rng(3), tg.m)
    jp, tp = prepared("rmat", w)
    srcs = [0, 17, 200]
    got = sssp_distances(srcs, problem=tp.problem, wplane=tp.wplane,
                         weights=tp.weights, delta=delta)
    np.testing.assert_array_equal(got, sssp_ref(tg, srcs, w))
    np.testing.assert_array_equal(got, j_sssp_distances(
        srcs, problem=jp.problem, wplane=jp.wplane, weights=jp.weights,
        delta=delta))


def test_sssp_runs_the_reference_relaxations():
    """The host loops keep the reference's rounds: the relaxations and
    bucket rounds counted on a fixed input do not depend on the batch."""
    tg = T_FAM["grid"]
    w = dyadic(np.random.default_rng(4), tg.m)
    _, tp = prepared("grid", w)
    f = make_sssp(tp.problem, tp.wplane, 2)
    d = f(np.array([0, 5]), 1.0)
    assert f.stats["relaxations"] > 0 and f.stats["rounds"] > 0
    assert f.stats["host_syncs"] == (f.stats["relaxations"]
                                     + f.stats["rounds"] + 1)
    np.testing.assert_array_equal(d.numpy().T, sssp_ref(tg, [0, 5], w))


def test_next_btop_steps_past_rem():
    import torch
    rem = torch.tensor([0.3, 3.0, float("inf"), 1e-30], dtype=torch.float32)
    btop = torch.tensor([1.0, 1.0, 5.0, 1.0], dtype=torch.float32)
    delta = torch.tensor(1.0, dtype=torch.float32)
    nbt = _next_btop(rem, btop, delta)
    assert (nbt[[0, 1, 3]] > rem[[0, 1, 3]]).all() and nbt[2] == 5.0
    tiny = _next_btop(torch.tensor([1.0]), torch.tensor([0.0]),
                      torch.tensor(1e-30))
    assert tiny[0] > 1.0


def test_sssp_needs_a_plane_and_default_delta():
    _, tp = prepared("rmat", None)
    with pytest.raises(ConfigError, match="weight plane"):
        make_sssp(tp.problem, None, 2)
    assert default_delta(np.array([1.0, 3.0])) == 2.0
    assert default_delta(np.array([])) == 1.0


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------
def rel_err(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("name", sorted(J_FAM))
def test_pagerank_matches_reference_and_oracle(name):
    """Scale-free, grid, a dangling star, a disconnected graph, a single
    vertex and a graph whose n is a multiple of σ."""
    jg, tg = J_FAM[name], T_FAM[name]
    jprob = JProblem.build(j_build_bvss(jg))
    tprob = BlestProblem.build(build_bvss(tg), "cpu")
    got = pagerank_scores(tg, problem=tprob)
    want = j_pagerank_scores(jg, problem=jprob)
    assert got.dtype == np.float64 and got.shape == (tg.n,)
    assert rel_err(got, want) <= 1e-6
    assert rel_err(got, pagerank_ref(tg)) <= 1e-6
    assert abs(got.sum() - 1.0) <= 1e-5


def test_pagerank_iterations_match_reference_cap():
    """max_iter caps the host loop as it caps the reference's loop."""
    jg, tg = J_FAM["rmat"], T_FAM["rmat"]
    tprob = BlestProblem.build(build_bvss(tg), "cpu")
    f = make_pagerank(tprob, out_degrees(tg), max_iter=3)
    got = f().numpy()
    assert f.stats["iterations"] == 3 == f.stats["host_syncs"]
    want = np.asarray(j_make_pagerank(JProblem.build(j_build_bvss(jg)),
                                      np.diff(jg.indptr).astype(np.float32),
                                      max_iter=3)())
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("name", ["rmat", "star", "disc"])
def test_pagerank_oracle_matches_reference_oracle(name):
    """The port's float64 power iteration against the reference's NetworkX
    oracle (run to a tolerance tight enough for rtol 1e-9)."""
    np.testing.assert_allclose(pagerank_ref(T_FAM[name]),
                               j_pagerank_ref(J_FAM[name], tol=1e-15),
                               rtol=1e-9)
