"""Brandes betweenness of the PyTorch port against the JAX reference, on
the CPU: the σ path-count channel of the wave engine level by level, the
recorded queue history, ``make_betweenness``, ``betweenness_centrality``
and the port's own level-synchronous Brandes oracle.

The same numpy-seeded inputs go through ``repro`` (its Pallas kernels in
interpret mode) and ``repro_torch`` (the kernels' PyTorch twins).  Levels
and σ (integers in float32) must be equal; δ agrees to rtol 1e-5 (its
float sums run in another order), betweenness to the reference tests'
rtol 1e-4, atol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.multi_source as jms
from repro.analytics import betweenness_centrality as j_betweenness
from repro.analytics import make_betweenness as j_make_betweenness
from repro.core.bfs import BlestProblem as JProblem
from repro.core.bfs import make_queue_history as j_make_queue_history
from repro.core.bfs import queue_widths as j_queue_widths
from repro.core.bvss import build_bvss as j_build_bvss
from repro.core.level_pipeline import LevelPipeline as JPipeline
from repro.core.level_pipeline import run_levels_recorded as j_run_recorded
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro.kernels.ref import betweenness_ref as j_betweenness_ref
import repro_torch.core.multi_source as tms
from repro_torch.analytics import betweenness_centrality, make_betweenness
from repro_torch.core.bfs import (BlestProblem, make_queue_history,
                                  queue_widths)
from repro_torch.core.bvss import build_bvss
from repro_torch.core.level_pipeline import LevelPipeline, run_levels_recorded
from repro_torch.errors import ConfigError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.ref import betweenness_ref
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.iinfo(np.int32).max


def families(gen, from_edges):
    """tests/test_analytics.py's FAMILIES: scale-free, grid, star,
    clustered, and a graph of many components with isolated vertices."""
    return {
        "rmat": gen.rmat(8, 8, seed=1),
        "grid": gen.grid2d(8, 8, shuffle=True, seed=3),
        "star": gen.star(48),
        "clustered": gen.clustered(3, 16, seed=4),
        "disc": from_edges(40, np.array([0, 1, 2, 10, 11, 20, 21]),
                           np.array([1, 2, 0, 11, 12, 21, 22])),
    }


J_FAM = families(jgen, j_from_edges)
T_FAM = families(tgen, t_from_edges)


def problems(name):
    jp = JProblem.build(j_build_bvss(J_FAM[name]))
    tp = BlestProblem.build(build_bvss(T_FAM[name]), "cpu")
    return jp, tp


# ---------------------------------------------------------------------------
# the σ channel and the queue history
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["rmat", "grid", "disc"])
def test_sigma_channel_matches_reference_level_by_level(name):
    """init, level_step and a mid-flight insert + requeue: levels, σ and
    the frontier equal after every level."""
    jp, tp = problems(name)
    je = jms.make_ms_engine(jp, 3, track_sigma=True)
    te = tms.make_ms_engine(tp, 3, track_sigma=True)
    srcs = np.array([1, 5, tp.n - 1])
    js, ts = je.init(jnp.asarray(srcs, jnp.int32)), te.init(srcs)
    n = tp.n
    for lvl in range(10):
        if lvl == 2:    # refill slot 1 mid-flight
            js = je.requeue(je.insert(js, 1, 7))
            ts = te.requeue(te.insert(ts, 1, 7))
        js, jlive = je.level_step(js)
        ts, tlive = te.level_step(ts)
        np.testing.assert_array_equal(tlive, np.asarray(jlive))
        np.testing.assert_array_equal(ts.levels[:n].numpy(),
                                      np.asarray(js.levels)[:n])
        assert ts.paths.dtype == torch.float32
        np.testing.assert_array_equal(ts.paths.numpy(), np.asarray(js.paths))
        np.testing.assert_array_equal(te.paths_of(ts, 2).numpy(),
                                      np.asarray(je.paths_of(js, 2)))


def test_sigma_channel_insert_batch_resets_paths():
    jp, tp = problems("rmat")
    je = jms.make_ms_engine(jp, 2, track_sigma=True)
    te = tms.make_ms_engine(tp, 2, track_sigma=True)
    js, ts = je.init(jnp.asarray([3, 4], jnp.int32)), te.init([3, 4])
    for _ in range(2):
        js, _ = je.level_step(js)
        ts, _ = te.level_step(ts)
    srcs, mask = np.array([0, 9]), np.array([False, True])
    js = je.insert_batch(js, jnp.asarray(srcs, jnp.int32), jnp.asarray(mask))
    ts = te.insert_batch(ts, srcs, mask)
    for _ in range(3):
        js, _ = je.level_step(js)
        ts, _ = te.level_step(ts)
        np.testing.assert_array_equal(ts.paths.numpy(), np.asarray(js.paths))


def test_track_sigma_is_pull_only():
    _, tp = problems("rmat")
    with pytest.raises(ConfigError, match="pull-only"):
        tms.make_ms_engine(tp, 2, track_sigma=True, direction="push")
    eng = tms.make_ms_engine(tp, 2, track_sigma=True, direction="auto")
    st = eng.init([0, 1])
    for _ in range(4):
        st, _ = eng.level_step(st)
    assert eng.stats["push_levels"] == 0 and eng.stats["pull_levels"] > 0
    assert tms.make_ms_engine(tp, 2).paths_of is None


def test_spmm_w_seam_is_used():
    _, tp = problems("rmat")
    calls = []

    def spy(masks, xv, sigma):
        calls.append(xv.shape)
        from repro_torch.kernels.ref import bvss_spmm_w_ref
        return bvss_spmm_w_ref(masks, xv, sigma)

    eng = tms.make_ms_engine(tp, 2, track_sigma=True, spmm_w_impl=spy)
    eng.level_step(eng.init([0, 1]))
    assert calls and calls[0][1:] == (tp.sigma, 2)


@pytest.mark.parametrize("name", ["rmat", "grid", "clustered"])
def test_recorded_queue_prefixes_equal_reference(name):
    """The port records each level's queue at the width its pull ran; the
    live prefix equals the reference's ``hist.Q[lvl, :count]``."""
    jp, tp = problems(name)
    srcs = np.array([0, 3, 17])
    je = jms.make_ms_engine(jp, 3, track_sigma=True)
    jwidths = j_queue_widths(jp.num_vss, 2)
    jhist0, jrecord = j_make_queue_history(jwidths[-1], jp.n + 1, jp.num_vss)
    jpipe = JPipeline(step=lambda s, lvl: je.step(s),
                      finalize=lambda s, lvl: je.finalize(s),
                      active=lambda s: s.cont)
    _, jlv, jhist = j_run_recorded(jpipe, je.init(jnp.asarray(srcs, jnp.int32)),
                                   max_levels=jp.n + 1, history=jhist0,
                                   record=jrecord)
    te = tms.make_ms_engine(tp, 3, track_sigma=True)
    hist0, record = make_queue_history(queue_widths(tp.num_vss, 2))
    tpipe = LevelPipeline(step=lambda s, lvl: te.step(s),
                          finalize=lambda s, lvl: te.finalize(s),
                          active=lambda s: s.cont)
    _, tlv, hist = run_levels_recorded(tpipe, te.init(srcs),
                                       max_levels=tp.n + 1, history=hist0,
                                       record=record)
    assert tlv == int(jlv) and len(hist.Q) == tlv > 0
    for lvl in range(1, tlv + 1):
        count = int(jhist.count[lvl])
        assert hist.count[lvl - 1] == count
        np.testing.assert_array_equal(
            hist.Q[lvl - 1][:count].numpy(),
            np.asarray(jhist.Q[lvl, :count]))
        # past the live count the recorded prefix is dummy padding
        assert (hist.Q[lvl - 1][count:] == tp.num_vss).all()


# ---------------------------------------------------------------------------
# make_betweenness and betweenness_centrality
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(J_FAM))
def test_make_betweenness_matches_reference(name):
    """Levels and σ equal, δ to rtol 1e-5; sources include an isolated
    vertex on the disconnected graph."""
    jp, tp = problems(name)
    srcs = np.array([0, 5, tp.n - 1], dtype=np.int32)
    jl, js, jd = (np.asarray(a) for a in
                  j_make_betweenness(jp, 3)(jnp.asarray(srcs)))
    tl, ts, td = make_betweenness(tp, 3)(srcs)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)
    assert (td.numpy()[srcs, np.arange(3)] == 0).all()


@pytest.mark.parametrize("name", sorted(J_FAM))
def test_betweenness_centrality_matches_reference_and_oracle(name):
    """7 sources through cohorts of 3: a padded tail cohort; a duplicate
    source counts twice."""
    jg, tg = J_FAM[name], T_FAM[name]
    srcs = np.random.default_rng(0).integers(0, tg.n, 7)
    srcs[4] = srcs[1]
    got = betweenness_centrality(tg, srcs, batch=3, device="cpu")
    want = j_betweenness(jg, srcs, batch=3)
    assert got.dtype == np.float64 and got.shape == (tg.n,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, j_betweenness_ref(jg, srcs), rtol=1e-4,
                               atol=1e-4)


def test_betweenness_edge_cases():
    g = T_FAM["disc"]
    assert (betweenness_centrality(g, [], device="cpu") == 0).all()
    # isolated sources only: no dependency anywhere
    bc = betweenness_centrality(g, [35, 36, 39], device="cpu")
    np.testing.assert_array_equal(bc, np.zeros(g.n))
    # a single vertex and an edgeless graph
    one = t_from_edges(1, np.array([], np.int64), np.array([], np.int64))
    np.testing.assert_array_equal(
        betweenness_centrality(one, [0], device="cpu"), [0.0])
    # a path: interior vertex v lies on (v)·(n-1-v) source pairs from 0..
    p = t_from_edges(6, np.arange(5), np.arange(1, 6))
    np.testing.assert_allclose(
        betweenness_centrality(p, np.arange(6), device="cpu"),
        betweenness_ref(p, np.arange(6)))


@pytest.mark.parametrize("name", sorted(J_FAM))
def test_brandes_oracle_matches_reference_oracle(name):
    """The port's level-synchronous Brandes against the reference's
    per-edge Brandes, both float64."""
    jg, tg = J_FAM[name], T_FAM[name]
    srcs = np.random.default_rng(1).integers(0, tg.n, 6)
    np.testing.assert_allclose(betweenness_ref(tg, srcs),
                               j_betweenness_ref(jg, srcs), rtol=1e-9,
                               atol=1e-12)
