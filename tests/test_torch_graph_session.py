"""``repro_torch.GraphSession`` wave serving against ``repro.GraphSession``,
on the CPU: ``levels_batch`` bit for bit through the slot pool with
mid-flight refills, duplicate and isolated sources, every direction and
the harvest hooks; the singleton path; the caller-id contract of the
closeness verbs; and the verbs and options of later slices, which raise
:class:`ConfigError`."""
import warnings

import numpy as np
import pytest

import repro
import repro_torch
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro_torch.errors import ConfigError, GraphValidationError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen

INF = np.iinfo(np.int32).max


def families(gen, from_edges):
    return {
        "rmat": gen.rmat(8, 8, seed=1),
        "grid": gen.grid2d(17, 19),
        "clustered": gen.clustered(8, 32, seed=4),
        "disconnected": from_edges(50, np.array([1, 2, 10]),
                                   np.array([2, 3, 11])),
        "flip": gen.clustered(40, 60, p_in=0.4, seed=1),
        "path": from_edges(60, np.arange(59), np.arange(1, 60)),
    }


J_FAM = families(jgen, j_from_edges)
T_FAM = families(tgen, t_from_edges)


def session_pair(name, max_batch=3, **opts):
    js = repro.GraphSession(J_FAM[name], max_batch=max_batch,
                            options=repro.PrepareOptions(**opts))
    ts = repro_torch.GraphSession(
        T_FAM[name], max_batch=max_batch,
        options=repro_torch.PrepareOptions(device="cpu", **opts))
    return js, ts


@pytest.fixture(scope="module")
def social_pair():
    """rmat sessions whose ordering is non-trivial (perm != identity), so
    any id-space slip shows up as a mismatch."""
    js, ts = session_pair("rmat", w=256)
    assert ts.ordering == js.ordering == "jaccard_windows"
    assert (ts.perm != np.arange(ts.n)).any()
    return js, ts


def assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
        else:
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w, err_msg=f"query {i}")


@pytest.mark.parametrize("name", ["rmat", "grid", "clustered",
                                  "disconnected"])
def test_levels_batch_matches_reference(name):
    """More queries than slots (refills), a duplicate query, and on the
    disconnected graph isolated sources: equal answers, in caller ids,
    equal to the host oracle."""
    js, ts = session_pair(name)
    n = ts.n
    queries = [int(q) for q in np.random.default_rng(0).integers(0, n, 7)]
    queries[3] = queries[0]
    if name == "disconnected":
        queries[5:] = [40, 49]
    got = ts.levels_batch(queries)
    assert_same(got, js.levels_batch(queries))
    for q, lv in zip(queries, got):
        np.testing.assert_array_equal(lv, repro_torch.reference_bfs(
            T_FAM[name], q))


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
def test_levels_batch_directions_match_reference(direction):
    js, ts = session_pair("flip", max_batch=4, direction=direction,
                          order=False)
    queries = [0, 1111, 2399, 7, 1200, 5]
    assert_same(ts.levels_batch(queries), js.levels_batch(queries))
    stats = ts._ms.stats
    if direction == "auto":
        assert stats["push_levels"] > 0 and stats["pull_levels"] > 0


def test_columns_converge_at_different_levels():
    """Near-converging and deep queries on a directed path: a slot freed
    by a shallow query is refilled while deep columns still run."""
    js, ts = session_pair("path", max_batch=2, order=False)
    queries = [58, 0, 55, 2, 59]                 # depths 1, 59, 4, 57, 0
    assert_same(ts.levels_batch(queries), js.levels_batch(queries))


@pytest.mark.parametrize("target", [1, 4])
def test_harvest_hooks_match_reference(social_pair, target):
    """Request ``target`` is cancelled at its second offer: the same offers
    in the same order, the same partial levels, None at its index, and
    every other answer complete."""
    js, ts = social_pair
    queries = [3, 77, 100, 5, 9, 200, 31]

    def run(sess):
        offers, partial = [], {}

        def should_harvest(i):
            offers.append(i)
            return i == target and offers.count(i) == 2

        def on_harvested(i, lv):
            partial[i] = lv

        out = sess.levels_batch(queries, should_harvest=should_harvest,
                                on_harvested=on_harvested)
        return out, offers, partial

    got, want = run(ts), run(js)
    assert_same(got[0], want[0])
    assert got[1] == want[1]
    assert got[2].keys() == want[2].keys() == {target}
    np.testing.assert_array_equal(got[2][target], want[2][target])
    assert got[0][target] is None and (got[2][target] == INF).any()


def test_singleton_takes_the_single_source_engine(social_pair):
    import dataclasses
    js, ts = social_pair
    calls = {"wave": 0}
    real = ts._ms.level_step

    def spy(st):
        calls["wave"] += 1
        return real(st)

    ts._ms = dataclasses.replace(ts._ms, level_step=spy)
    try:
        [lv] = ts.levels_batch([5])
        assert calls["wave"] == 0
        # a singleton WITH hooks rides the wave pool
        [lv2] = ts.levels_batch([5], should_harvest=lambda i: False)
        assert calls["wave"] > 0
    finally:
        ts._ms = dataclasses.replace(ts._ms, level_step=real)
    np.testing.assert_array_equal(lv, js.levels(5))
    np.testing.assert_array_equal(lv2, lv)


def test_empty_batch_and_bad_sources(social_pair):
    _, ts = social_pair
    assert ts.levels_batch([]) == []
    with pytest.raises(GraphValidationError):
        ts.levels_batch([0, ts.n])
    with pytest.raises(GraphValidationError):
        ts.levels_batch([0, -1])


def test_non_convergence_guard():
    g = tgen.rmat(6, 4, seed=0)
    sess = repro_torch.GraphSession(
        g, max_batch=2, max_steps=0,
        options=repro_torch.PrepareOptions(order=False, device="cpu"))
    with pytest.raises(RuntimeError, match="did not converge"):
        sess.levels_batch([0, 1])


def test_session_shares_prepared_problem():
    _, ts = session_pair("grid", max_batch=2)
    assert ts._ms.problem is ts.prepared.problem
    assert ts.engine_name == ts.prepared.engine_name
    np.testing.assert_array_equal(ts.inv[ts.perm], np.arange(ts.n))


def test_closeness_sample_and_aliases_match_reference(social_pair):
    """Sampled closeness in caller ids (the old example's regression), the
    deprecated aliases warning and answering the same."""
    js, ts = social_pair
    srcs, cc = ts.closeness_sample(6, seed=2)
    jsrcs, jcc = js.closeness_sample(6, seed=2)
    np.testing.assert_array_equal(srcs, jsrcs)
    np.testing.assert_allclose(cc, jcc, rtol=1e-12)
    with pytest.warns(DeprecationWarning, match="closeness_sample"):
        asrcs, acc = ts.centrality_sample(6, seed=2)
    np.testing.assert_array_equal(asrcs, srcs)
    np.testing.assert_array_equal(acc, cc)
    with pytest.warns(DeprecationWarning, match="closeness_batch"):
        np.testing.assert_array_equal(ts.closeness(srcs), cc)
    with pytest.warns(DeprecationWarning, match="eccentricity_batch"):
        np.testing.assert_array_equal(ts.eccentricity([1, 2]),
                                      ts.eccentricity_batch([1, 2]))


def test_verbs_tuple_matches_reference():
    assert repro_torch.GraphSession.VERBS == repro.GraphSession.VERBS


@pytest.mark.parametrize("call,slice_name", [
    (lambda s: s.betweenness_batch([0, 1]), "betweenness slice"),
    (lambda s: s.betweenness([0, 1]), "betweenness slice"),
    (lambda s: s.betweenness_sample(2), "betweenness slice"),
    (lambda s: s.sssp(0), "SSSP/PageRank slice"),
    (lambda s: s.sssp_batch([0, 1]), "SSSP/PageRank slice"),
    (lambda s: s.pagerank(), "SSSP/PageRank slice"),
    (lambda s: s.update_edges([(0, 1)]), "incremental maintenance slice"),
])
def test_unported_verbs_raise(social_pair, call, slice_name):
    _, ts = social_pair
    with pytest.raises(ConfigError, match=slice_name):
        call(ts)


@pytest.mark.parametrize("kw,slice_name", [
    (dict(mesh=object()), "mesh slice"),
    (dict(weights=np.ones(4)), "SSSP/PageRank slice"),
    (dict(fault_plan=object()), "robust serving slice"),
    (dict(autotune=True), "autotuning slice"),
])
def test_unported_options_raise(kw, slice_name):
    g = tgen.path(4)
    with pytest.raises(ConfigError, match=slice_name):
        repro_torch.GraphSession(
            g, options=repro_torch.PrepareOptions(device="cpu"), **kw)


def test_build_problem_is_single_device():
    from repro_torch.core.policy import build_problem
    g = tgen.grid2d(5, 7)
    with pytest.raises(ConfigError, match="mesh slice"):
        build_problem(g, mesh=object(), device="cpu")
    p = build_problem(g, sigma=4, device="cpu")
    assert p.sigma == 4 and p.device.type == "cpu" and p.n == g.n


def test_options_and_keywords_are_exclusive():
    g = tgen.path(4)
    with pytest.raises(ConfigError, match="EITHER"):
        repro_torch.GraphSession(
            g, sigma=4, options=repro_torch.PrepareOptions(device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sess = repro_torch.GraphSession(
            g, max_batch=2, options=repro_torch.PrepareOptions(device="cpu"))
    assert sess.max_batch == 2 and sess.preprocess_s >= 0
