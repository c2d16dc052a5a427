"""The wave-client analytics of the PyTorch port against the JAX reference,
on the CPU: connected components, eccentricity, iFUB extremes and
closeness, through the module functions and through ``GraphSession``
(caller ids in and out), plus the SciPy host oracles.  Integers must be
equal; closeness scores agree to ``rtol=1e-12`` (both are the same
float64 reduction of equal integer levels, so they are in fact equal)."""
import dataclasses

import numpy as np
import pytest

import repro
import repro.analytics as jan
import repro.kernels.ref as jref
import repro_torch
import repro_torch.analytics as tan
import repro_torch.kernels.ref as tref
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
from torch_one_thread import one_torch_thread  # noqa: F401


def small_suite(gen, from_edges):
    """tests/test_analytics.py's suite."""
    return {
        "rmat": gen.rmat(6, 8, seed=1),
        "grid": gen.grid2d(8, 8, shuffle=True, seed=3),
        "star": gen.star(48),
        "clustered": gen.clustered(3, 16, seed=4),
        # many components + isolated vertices
        "disc": from_edges(40, np.array([0, 1, 2, 10, 11, 20, 21]),
                           np.array([1, 2, 0, 11, 12, 21, 22])),
    }


J_SUITE = small_suite(jgen, j_from_edges)
T_SUITE = small_suite(tgen, t_from_edges)
NAMES = sorted(T_SUITE)


def empty_graph(from_edges, n):
    z = np.array([], dtype=np.int64)
    return from_edges(n, z, z)


@pytest.mark.parametrize("name", NAMES)
def test_components_match_reference(name):
    want = jan.connected_components(J_SUITE[name], max_batch=4)
    got = tan.connected_components(T_SUITE[name], max_batch=4, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got,
                                  tref.connected_components_ref(T_SUITE[name]))


@pytest.mark.parametrize("n", [0, 1, 17])
def test_components_edge_cases(n):
    """Empty graph, one vertex, all vertices isolated."""
    got = tan.connected_components(empty_graph(t_from_edges, n),
                                   max_batch=4, device="cpu")
    want = jan.connected_components(empty_graph(j_from_edges, n),
                                    max_batch=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.arange(n))


@pytest.mark.parametrize("name", ["rmat", "grid", "star", "disc"])
def test_eccentricities_match_reference(name):
    jg, tg = J_SUITE[name].symmetrized, T_SUITE[name].symmetrized
    srcs = np.random.default_rng(1).integers(0, tg.n, 6)
    got = tan.eccentricities(srcs, g=tg, batch=4, device="cpu")
    np.testing.assert_array_equal(got, jan.eccentricities(srcs, g=jg,
                                                          batch=4))
    np.testing.assert_array_equal(got, tref.eccentricity_ref(tg, srcs))


@pytest.mark.parametrize("max_evals", [None, 4])
@pytest.mark.parametrize("name", ["rmat", "grid", "star", "clustered"])
def test_ifub_extremes_match_reference(name, max_evals):
    """Certified diameters, and explicit bounds under an eval budget: every
    field of the report equal."""
    got = tan.ifub_extremes(T_SUITE[name], batch=4, max_evals=max_evals,
                            device="cpu")
    want = jan.ifub_extremes(J_SUITE[name], batch=4, max_evals=max_evals)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.exact == want.exact
    if max_evals is None:
        assert got.exact


@pytest.mark.parametrize("name", NAMES)
def test_closeness_matches_reference(name):
    jg, tg = J_SUITE[name], T_SUITE[name]
    srcs = np.random.default_rng(5).integers(0, tg.n, 7)
    got = tan.closeness_centrality(tg, srcs, batch=3, device="cpu")
    np.testing.assert_allclose(got, jan.closeness_centrality(jg, srcs,
                                                             batch=3),
                               rtol=1e-12)
    np.testing.assert_allclose(got, tref.closeness_ref(tg, srcs),
                               rtol=1e-12)


def test_closeness_edge_cases():
    g = empty_graph(t_from_edges, 9)
    assert (tan.closeness_centrality(g, [0, 4, 8], batch=2,
                                     device="cpu") == 0).all()
    assert len(tan.closeness_centrality(T_SUITE["rmat"], [],
                                        device="cpu")) == 0
    assert (tan.closeness_centrality(empty_graph(t_from_edges, 1),
                                     device="cpu") == [0.0]).all()
    cc = tan.closeness_centrality(T_SUITE["grid"], [7, 7, 3], batch=2,
                                  device="cpu")
    assert cc[0] == cc[1]


@pytest.mark.parametrize("name", NAMES)
def test_host_oracles_match_reference(name):
    """The port's copies of the SciPy/NumPy oracles equal the reference's."""
    jg, tg = J_SUITE[name], T_SUITE[name]
    srcs = np.arange(0, tg.n, 5)
    np.testing.assert_array_equal(tref.connected_components_ref(tg),
                                  jref.connected_components_ref(jg))
    np.testing.assert_array_equal(tref.eccentricity_ref(tg, srcs),
                                  jref.eccentricity_ref(jg, srcs))
    for wf in (False, True):
        np.testing.assert_array_equal(
            tref.closeness_ref(tg, wf_improved=wf),
            jref.closeness_ref(jg, wf_improved=wf))
    labels = np.random.default_rng(0).integers(-5, 9, 30)
    np.testing.assert_array_equal(tref.normalize_labels(labels),
                                  jref.normalize_labels(labels))


@pytest.fixture(scope="module")
def session_pair():
    """Ordering ON, so internal ids differ from caller ids."""
    jg, tg = J_SUITE["rmat"], T_SUITE["rmat"]
    js = repro.GraphSession(jg, max_batch=4)
    ts = repro_torch.GraphSession(
        tg, max_batch=4, options=repro_torch.PrepareOptions(device="cpu"))
    assert (ts.perm != np.arange(ts.n)).any()
    return js, ts


def test_session_components_match_reference(session_pair):
    js, ts = session_pair
    got = ts.components()
    np.testing.assert_array_equal(got, js.components())
    np.testing.assert_array_equal(
        got, tref.connected_components_ref(T_SUITE["rmat"]))


def test_session_eccentricity_batch_matches_reference(session_pair):
    js, ts = session_pair
    srcs = np.random.default_rng(3).integers(0, ts.n, 5)
    got = ts.eccentricity_batch(srcs)
    np.testing.assert_array_equal(got, js.eccentricity_batch(srcs))
    np.testing.assert_array_equal(
        got, tref.eccentricity_ref(T_SUITE["rmat"].symmetrized, srcs))
    assert len(ts.eccentricity_batch([])) == 0


@pytest.mark.parametrize("max_evals", [None, 6])
def test_session_extremes_match_reference(session_pair, max_evals):
    """Center and periphery in caller ids, inside the largest component."""
    js, ts = session_pair
    got = ts.extremes(max_evals=max_evals)
    assert dataclasses.astuple(got) == \
        dataclasses.astuple(js.extremes(max_evals=max_evals))
    comp = tref.connected_components_ref(T_SUITE["rmat"])
    big = np.bincount(comp).argmax()
    assert comp[got.center] == big and comp[got.periphery] == big


@pytest.mark.parametrize("wf", [False, True])
def test_session_closeness_batch_matches_reference(session_pair, wf):
    """Sampled and exact (sources=None) closeness, caller-id order."""
    js, ts = session_pair
    srcs = np.random.default_rng(7).integers(0, ts.n, 5)
    np.testing.assert_allclose(ts.closeness_batch(srcs, wf_improved=wf),
                               js.closeness_batch(srcs, wf_improved=wf),
                               rtol=1e-12)
    exact = ts.closeness_batch(wf_improved=wf)
    np.testing.assert_allclose(exact, js.closeness_batch(wf_improved=wf),
                               rtol=1e-12)
    np.testing.assert_allclose(
        exact, tref.closeness_ref(T_SUITE["rmat"], wf_improved=wf),
        rtol=1e-12)
