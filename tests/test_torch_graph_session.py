"""``repro_torch.GraphSession`` wave serving against ``repro.GraphSession``,
on the CPU: ``levels_batch`` bit for bit through the slot pool with
mid-flight refills, duplicate and isolated sources, every direction and
the harvest hooks; the singleton path; the caller-id contract of the
closeness verbs; the float-channel verbs (betweenness, SSSP, PageRank)
and the ``weights=`` option, in caller ids; ``update_edges`` (the reports,
the next epoch's answers, a wave that updates mid-flight, components
after a merge) and ``autotune=True``; and the ``mesh`` option of a later
slice, which raises :class:`ConfigError`."""
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
from torch_one_thread import one_torch_thread  # noqa: F401

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
    stats = ts.counters()["wave"]
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


def caller_edges(sess):
    """The session's edges in caller ids, as a set of pairs."""
    from repro_torch.graphs import src_of_edges
    g = sess.prepared.graph
    return set(zip(sess.inv[src_of_edges(g)].tolist(),
                   sess.inv[g.indices].tolist()))


def caller_graph(sess):
    src, dst = map(np.array, zip(*sorted(caller_edges(sess))))
    return t_from_edges(sess.n, src, dst)


def test_update_edges_matches_reference(weighted_pair):
    """Inserts, deletes and reweights in caller ids through both sessions:
    the same reports and epochs, then the same levels, waves, SSSP and
    betweenness on the new epoch, equal to the oracles of the mutated
    graph; a no-op returns None; a stale ``expected_epoch`` raises."""
    from repro.kernels.ref import betweenness_ref, sssp_ref
    _, _, w = weighted_pair
    js = repro.GraphSession(J_FAM["rmat"], max_batch=3,
                            options=repro.PrepareOptions(
                                w=256, weights=w, use_kernels=False))
    ts = repro_torch.GraphSession(
        T_FAM["rmat"], max_batch=3,
        options=repro_torch.PrepareOptions(device="cpu", w=256, weights=w))
    rng = np.random.default_rng(12)
    have = sorted(caller_edges(ts))
    dels = [have[i] for i in rng.choice(len(have), 4, replace=False)]
    ins = [(int(a), int(b)) for a, b in rng.integers(0, ts.n, (12, 2))
           if a != b and (int(a), int(b)) not in set(have)][:6]
    rew = [e for e in have if e not in dels][:2]
    wts = [0.5, 1.25, 3.0, 0.75, 2.0, 1.5, 4.0, 0.25][:len(ins) + 2]
    kw = dict(inserts=ins + rew, deletes=dels, insert_weights=wts)
    rep, jrep = ts.update_edges(**kw), js.update_edges(**kw)
    import dataclasses
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.n_reweighted == 2 and ts.epoch == js.epoch == 1
    g_now = caller_graph(ts)
    jg_now = j_from_edges(ts.n, *map(np.array, zip(*sorted(
        caller_edges(ts)))))
    queries = [3, 17, 100, 255, 5]
    got = ts.levels_batch(queries)
    assert_same(got, js.levels_batch(queries))
    for q, lv in zip(queries, got):
        np.testing.assert_array_equal(lv, repro_torch.reference_bfs(g_now,
                                                                    q))
    # the weights in caller CSR order: sorted by caller (src, dst) key
    w_now = ts.prepared.weights[np.argsort(
        ts.inv[src_of(ts)] * ts.n + ts.inv[ts.prepared.graph.indices],
        kind="stable")]
    d = ts.sssp_batch(queries[:3])
    np.testing.assert_array_equal(d, js.sssp_batch(queries[:3]))
    np.testing.assert_array_equal(d, sssp_ref(jg_now, queries[:3], w_now))
    bc = ts.betweenness_batch(queries[:3])
    np.testing.assert_allclose(bc, betweenness_ref(jg_now, queries[:3]),
                               rtol=1e-4, atol=1e-4)
    assert ts.update_edges(inserts=[ins[0]], insert_weights=[0.5]) \
        is not None                                  # a reweight
    assert ts.update_edges() is None and ts.epoch == 2
    from repro_torch.errors import StaleEpochError
    with pytest.raises(StaleEpochError):
        ts.update_edges(deletes=[rew[0]], expected_epoch=1)


def src_of(sess):
    from repro_torch.graphs import src_of_edges
    return src_of_edges(sess.prepared.graph)


def test_update_edges_mid_wave_keeps_the_old_epoch():
    """A wave whose hook updates the session after its first harvest
    finishes on the epoch it started with, in both packages: every other
    request gets the old graph's answer; the next wave sees the new one."""
    queries = [0, 3, 77, 100, 5, 9]
    out = {}
    for pkg, fam in ((repro, J_FAM), (repro_torch, T_FAM)):
        opts = dict(w=256)
        opts.update(use_kernels=False) if pkg is repro else \
            opts.update(device="cpu")
        sess = pkg.GraphSession(fam["rmat"], max_batch=3,
                                options=pkg.PrepareOptions(**opts))
        lv0 = sess.levels(0)
        far = int(np.argmax(lv0 == INF))
        reports = []

        def on_harvested(i, lv, sess=sess, far=far):
            reports.append(sess.update_edges(inserts=[(0, far)]))

        got = sess.levels_batch(queries,
                                should_harvest=lambda i: i == 0 and
                                not reports, on_harvested=on_harvested)
        assert len(reports) == 1 and reports[0].epoch == sess.epoch == 1
        assert got[0] is None
        for q, lv in zip(queries[1:], got[1:]):
            np.testing.assert_array_equal(
                lv, repro_torch.reference_bfs(T_FAM["rmat"], q))
        assert sess.levels_batch([0, 3])[0][far] == 1
        out[pkg.__name__] = got
    assert_same(out["repro_torch"], out["repro"])


def test_components_after_merging_update():
    """components() after an update that merges two components: the
    symmetrised problem behind it is rebuilt for the new epoch."""
    js, ts = session_pair("disconnected", use_kernels=False)
    before = ts.components()
    np.testing.assert_array_equal(before, js.components())
    assert before[3] != before[10]
    rep = ts.update_edges(inserts=[(3, 10)])
    js.update_edges(inserts=[(3, 10)])
    after = ts.components()
    np.testing.assert_array_equal(after, js.components())
    assert after[3] == after[10] == after[1] == after[11]
    assert after.max() == before.max() - 1 and rep.epoch == 1


def test_autotune_session_matches_reference(monkeypatch):
    """GraphSession(autotune=True): under one fake timer both packages tune
    the same knobs into the session's engine, and serve the same levels."""
    import repro.core.autotune as jat
    import repro_torch.core.autotune as tat

    def fake(fn, args, reps):
        return 1e-5 + 1e-8 * int(args[0].shape[0])

    monkeypatch.setattr(jat, "_time_call", fake)
    monkeypatch.setattr(tat, "_time_call", fake)
    jat.clear_cache()
    tat.clear_cache()
    try:
        js = repro.GraphSession(J_FAM["grid"], max_batch=3, autotune=True,
                                use_kernel=False)
        ts = repro_torch.GraphSession(
            T_FAM["grid"], max_batch=3,
            options=repro_torch.PrepareOptions(device="cpu", autotune=True))
        jc, tc = js.prepared.tile_config, ts.prepared.tile_config
        assert (tc.pull_widths, tc.push_cap, tc.source) == \
            (jc.pull_widths, jc.push_cap, jc.source) == \
            (tc.pull_widths, 128, "tuned")
        queries = [0, 7, 100, 300]
        assert_same(ts.levels_batch(queries), js.levels_batch(queries))
        np.testing.assert_array_equal(ts.levels(5), js.levels(5))
        # the tuned knobs survive an epoch swap
        ts.update_edges(inserts=[(0, 300)])
        assert ts.prepared.tile_config == tc
        np.testing.assert_array_equal(
            ts.levels(0), repro_torch.reference_bfs(caller_graph(ts), 0))
    finally:
        jat.clear_cache()
        tat.clear_cache()


@pytest.mark.parametrize("kw,slice_name", [
    (dict(mesh=object()), "EITHER"),
])
def test_unported_options_raise(kw, slice_name):
    """A session's ``mesh=`` is ported (``tests/test_torch_mesh_session.py``
    serves it on gloo ranks); beside ``options=`` the keyword is the
    reference's ConfigError, in both packages."""
    g = tgen.path(4)
    with pytest.raises(ConfigError, match=slice_name):
        repro_torch.GraphSession(
            g, options=repro_torch.PrepareOptions(device="cpu"), **kw)
    with pytest.raises(repro.ConfigError, match=slice_name):
        repro.GraphSession(J_FAM["path"], options=repro.PrepareOptions(),
                           **kw)


@pytest.mark.parametrize("plan", [None, "no_faults", "empty"])
def test_fault_plan_session_equals_plain_session(social_pair, plan):
    """A plan that injects nothing (``FaultPlan()``, ``NO_FAULTS``) adds no
    seam: the session serves what a session with no plan serves, on every
    path a plan could touch."""
    from repro_torch.serve import NO_FAULTS, FaultPlan
    fault_plan = {None: None, "no_faults": NO_FAULTS,
                  "empty": FaultPlan()}[plan]
    _, plain = social_pair
    ts = repro_torch.GraphSession(
        T_FAM["rmat"], max_batch=3, fault_plan=fault_plan,
        options=repro_torch.PrepareOptions(device="cpu", w=256))
    assert ts._seams == {} and not ts.fault_plan.injects
    assert ts.options.push_impl is None
    queries = [0, 7, 100, 3, 55]
    assert_same(ts.levels_batch(queries), plain.levels_batch(queries))
    for q in queries[:2]:
        np.testing.assert_array_equal(ts.levels(q), plain.levels(q))
    np.testing.assert_array_equal(ts.betweenness_batch(queries[:3]),
                                  plain.betweenness_batch(queries[:3]))
    np.testing.assert_array_equal(ts.components(), plain.components())


def test_build_problem_is_single_device():
    from repro_torch.core.policy import build_problem
    g = tgen.grid2d(5, 7)
    # a mesh must be a DeviceMesh (the sharded builds are
    # tests/test_torch_distributed*.py's)
    with pytest.raises(ConfigError, match="DeviceMesh"):
        build_problem(g, mesh=object(), device="cpu")
    p = build_problem(g, sigma=4, device="cpu")
    assert p.sigma == 4 and p.device.type == "cpu" and p.n == g.n
    # the options value supplies sigma and device; an explicit keyword wins
    opts = repro_torch.PrepareOptions(sigma=4, device="cpu")
    p = build_problem(g, options=opts)
    assert p.sigma == 4 and p.device.type == "cpu"
    assert build_problem(g, sigma=2, options=opts).sigma == 2


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


# ---------------------------------------------------------------------------
# the float-channel verbs and weights= (caller ids throughout)
# ---------------------------------------------------------------------------
def dyadic(rng, m):
    return (rng.integers(1, 128, m) / 32.0).astype(np.float32)


@pytest.fixture(scope="module")
def weighted_pair():
    """Weighted rmat sessions with a non-trivial ordering, so the weights
    must ride the permutation."""
    w = dyadic(np.random.default_rng(11), J_FAM["rmat"].m)
    js = repro.GraphSession(J_FAM["rmat"], max_batch=3,
                            options=repro.PrepareOptions(w=256, weights=w))
    ts = repro_torch.GraphSession(
        T_FAM["rmat"], max_batch=3,
        options=repro_torch.PrepareOptions(device="cpu", w=256, weights=w))
    assert (ts.perm != np.arange(ts.n)).any()
    return js, ts, w


def test_weights_option_matches_reference(weighted_pair):
    js, ts, w = weighted_pair
    np.testing.assert_array_equal(ts.prepared.weights, js.prepared.weights)
    np.testing.assert_array_equal(ts.prepared.wplane.numpy(),
                                  np.asarray(js.prepared.wplane))
    with pytest.raises(ConfigError, match="EITHER"):
        repro_torch.GraphSession(
            T_FAM["path"], weights=np.ones(T_FAM["path"].m),
            options=repro_torch.PrepareOptions(device="cpu"))


def test_betweenness_batch_matches_reference(weighted_pair):
    """5 queries through 3 slots (a padded tail cohort) and a duplicate;
    equal to the reference and its Brandes oracle, in caller ids."""
    from repro.kernels.ref import betweenness_ref
    js, ts, _ = weighted_pair
    srcs = [3, 17, 3, 100, 255]
    got = ts.betweenness_batch(srcs)
    np.testing.assert_allclose(got, js.betweenness_batch(srcs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, betweenness_ref(J_FAM["rmat"], srcs),
                               rtol=1e-4, atol=1e-4)
    assert (ts.betweenness_batch([]) == 0).all()


def test_betweenness_alias_and_sample_match_reference(weighted_pair):
    js, ts, _ = weighted_pair
    with pytest.warns(DeprecationWarning, match="betweenness_batch"):
        got = ts.betweenness([1, 2])
    np.testing.assert_allclose(got, ts.betweenness_batch([1, 2]))
    srcs, bc = ts.betweenness_sample(4, seed=2)
    jsrcs, jbc = js.betweenness_sample(4, seed=2)
    np.testing.assert_array_equal(srcs, jsrcs)
    np.testing.assert_allclose(bc, jbc, rtol=1e-4, atol=1e-4)


def test_sssp_and_sssp_batch_match_reference(weighted_pair):
    """Dyadic weights: equal to the reference and to Dijkstra exactly."""
    from repro.kernels.ref import sssp_ref
    js, ts, w = weighted_pair
    srcs = [3, 17, 100, 255]
    got = ts.sssp_batch(srcs)
    np.testing.assert_array_equal(got, js.sssp_batch(srcs))
    np.testing.assert_array_equal(got, sssp_ref(J_FAM["rmat"], srcs, w))
    np.testing.assert_array_equal(ts.sssp(17), got[1])
    np.testing.assert_array_equal(ts.sssp(17, delta=0.1), got[1])
    assert ts.sssp_batch([]).shape == (0, ts.n)


@pytest.mark.parametrize("name", ["rmat", "disconnected"])
def test_unweighted_sssp_equals_levels(name):
    """The lazy unit-weight plane: hop counts, +inf where unreached."""
    js, ts = session_pair(name)
    srcs = [0, 7, 41]
    got = ts.sssp_batch(srcs)
    np.testing.assert_array_equal(got, js.sssp_batch(srcs))
    for s, d in zip(srcs, got):
        lv = ts.levels(s)
        np.testing.assert_array_equal(d, np.where(lv == INF, np.inf, lv))


def test_pagerank_matches_reference(weighted_pair):
    """Structural PageRank in caller ids: session weights change nothing."""
    js, ts, _ = weighted_pair
    got = ts.pagerank()
    want = js.pagerank()
    assert np.max(np.abs(got - want) / want) <= 1e-6
    assert abs(got.sum() - 1.0) <= 1e-5
    _, plain = session_pair("rmat", w=256)
    assert np.max(np.abs(plain.pagerank() - got) / got) <= 1e-6
    short = ts.pagerank(max_iter=2, tol=0.0)
    assert np.max(np.abs(short - js.pagerank(max_iter=2, tol=0.0))
                  / short) <= 1e-6


def test_weighted_verbs_validate_sources(weighted_pair):
    _, ts, _ = weighted_pair
    with pytest.raises(GraphValidationError):
        ts.sssp(ts.n)
    with pytest.raises(GraphValidationError):
        ts.sssp_batch([0, -1])
    with pytest.raises(GraphValidationError):
        ts.betweenness_batch([ts.n + 3])
