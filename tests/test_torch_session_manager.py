"""GraphSessionManager of the port against the JAX package's, on the CPU:
admission control, tenant quotas, the byte-budgeted LRU of prepared state,
per-request deadlines with partial TimeoutResults, verify-mode sampling and
quarantine bookkeeping (DESIGN §2.7).

Every case of ``tests/test_session_manager.py`` runs here on the same
numpy-seeded graphs through ``repro.serve`` (its Pallas kernels in
interpret mode) and through ``repro_torch.serve`` with
``PrepareOptions(device="cpu")``, and each then holds the port's manager to
the reference's: levels, ``TimeoutResult`` fields, events, ``stats()``,
reason codes and ``session_cost_bytes`` exactly.  Deadlines run on an
injected clock, so both packages harvest at the same level.  Centrality
through the manager: betweenness within rtol 1e-4 / atol 1e-4, closeness
within 1e-12, the reference tests' tolerances.
"""
import warnings

import numpy as np
import pytest

import repro
import repro_torch
from repro.graphs import from_edges as jfrom_edges
from repro.graphs import generators as jgen
from repro_torch.core import reference_bfs
from repro_torch.errors import (AdmissionError, ConfigError,
                                DeadlineExceeded, GraphValidationError)
from repro_torch.graphs import from_edges
from repro_torch.graphs import generators as gen
from repro_torch.serve import (DegradedServiceWarning, GraphSessionManager,
                               TenantQuota, TimeoutResult,
                               session_cost_bytes)
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.int32(np.iinfo(np.int32).max)


@pytest.fixture(scope="module")
def graphs():
    return jgen.rmat(7, 8, seed=1), gen.rmat(7, 8, seed=1)


@pytest.fixture(scope="module")
def paths():
    """A 60-vertex directed path: depth 59 from vertex 0."""
    src, dst = np.arange(59), np.arange(1, 60)
    return jfrom_edges(60, src, dst), from_edges(60, src, dst)


class Pair:
    """A reference manager and a port manager driven call for call."""

    def __init__(self, graphs, **mgr_kwargs):
        self.jg, self.tg = graphs
        quota = mgr_kwargs.pop("default_quota", None)
        self.j = repro.GraphSessionManager(**mgr_kwargs, **(
            {} if quota is None else
            {"default_quota": repro.TenantQuota(**vars(quota))}))
        self.t = GraphSessionManager(**mgr_kwargs, **(
            {} if quota is None else {"default_quota": quota}))

    def open(self, name, *, tenant="default", max_batch=2, **opts):
        js = self.j.open_session(name, self.jg, tenant=tenant,
                                 max_batch=max_batch,
                                 options=repro.PrepareOptions(**opts))
        ts = self.t.open_session(
            name, self.tg, tenant=tenant, max_batch=max_batch,
            options=repro_torch.PrepareOptions(device="cpu", **opts))
        return js, ts

    def both(self, method, *args, **kwargs):
        """Call ``method`` on both managers; the port's result, the
        reference's result."""
        return (getattr(self.t, method)(*args, **kwargs),
                getattr(self.j, method)(*args, **kwargs))

    def refuse(self, method, *args, **kwargs) -> str:
        """Both managers refuse the call with an AdmissionError of one
        reason code; returns it."""
        with pytest.raises(AdmissionError) as ei:
            getattr(self.t, method)(*args, **kwargs)
        with pytest.raises(repro.AdmissionError) as ej:
            getattr(self.j, method)(*args, **kwargs)
        assert ei.value.reason == ej.value.reason
        return ei.value.reason

    def assert_books_equal(self):
        assert self.t.stats() == self.j.stats()
        assert self.t.events == self.j.events
        assert self.t.bytes_used() == self.j.bytes_used()


def stepping_clock(step: float = 1.0):
    """A clock that advances ``step`` seconds a reading."""
    t = {"now": 0.0}

    def clock():
        t["now"] += step
        return t["now"]

    return clock


def assert_same_levels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, repro.TimeoutResult):
            assert isinstance(g, TimeoutResult)
            assert (g.source, g.depth, g.deadline_s, g.complete) == \
                (w.source, w.depth, w.deadline_s, w.complete)
            np.testing.assert_array_equal(g.levels, w.levels)
            np.testing.assert_array_equal(g.frontier, w.frontier)
        else:
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# serving correctness through the manager
# ---------------------------------------------------------------------------
def test_serves_oracle_levels(graphs):
    p = Pair(graphs)
    p.open("g", max_batch=3)
    queries = [0, 5, 9, 20, 77]
    got, want = p.both("levels_batch", "g", queries)
    for q, lv in zip(queries, got):
        np.testing.assert_array_equal(lv, reference_bfs(p.tg, q))
    assert_same_levels(got, want)
    got, want = p.both("levels", "g", 9)
    np.testing.assert_array_equal(got, reference_bfs(p.tg, 9))
    np.testing.assert_array_equal(got, want)
    p.assert_books_equal()


def test_source_validation_through_manager(graphs):
    p = Pair(graphs)
    p.open("g")
    with pytest.raises(GraphValidationError):
        p.t.levels_batch("g", [0, -1])
    with pytest.raises(GraphValidationError):
        p.t.levels("g", p.tg.n)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_unknown_session_rejected(graphs):
    p = Pair(graphs)
    assert p.refuse("levels_batch", "nope", [0]) == "unknown-session"


def test_duplicate_name_rejected(graphs):
    p = Pair(graphs)
    p.open("g")
    with pytest.raises(AdmissionError) as ei:
        p.t.open_session("g", p.tg,
                         options=repro_torch.PrepareOptions(device="cpu"))
    assert ei.value.reason == "duplicate-name"


def test_tenant_isolation(graphs):
    """One tenant must not see (or even probe) another's sessions."""
    p = Pair(graphs)
    p.open("g", tenant="alice")
    assert p.refuse("levels_batch", "g", [0], tenant="bob") == \
        "unknown-session"
    # alice still works
    got, want = p.both("levels", "g", 0, tenant="alice")
    np.testing.assert_array_equal(got, reference_bfs(p.tg, 0))
    np.testing.assert_array_equal(got, want)
    p.assert_books_equal()


def test_tenant_session_quota(graphs):
    p = Pair(graphs, default_quota=TenantQuota(max_sessions=1))
    p.open("a")
    with pytest.raises(AdmissionError) as ei:
        p.t.open_session("b", p.tg, max_batch=2,
                         options=repro_torch.PrepareOptions(device="cpu"))
    assert ei.value.reason == "tenant-sessions"
    with pytest.raises(repro.AdmissionError):
        p.j.open_session("b", p.jg, max_batch=2)
    # another tenant has its own allowance
    p.open("b", tenant="other")
    p.assert_books_equal()


def test_tenant_byte_quota(graphs):
    p = Pair(graphs)
    js, ts = p.open("probe")
    cost = session_cost_bytes(ts)
    assert cost == repro.session_cost_bytes(js)
    p.both("close_session", "probe")
    for m in (p.t, p.j):
        m.set_quota("tiny", (TenantQuota if m is p.t else repro.TenantQuota)(
            max_bytes=cost // 2))
    with pytest.raises(AdmissionError) as ei:
        p.t.open_session("a", p.tg, tenant="tiny", max_batch=2,
                         options=repro_torch.PrepareOptions(device="cpu"))
    assert ei.value.reason == "tenant-bytes"
    with pytest.raises(repro.AdmissionError):
        p.j.open_session("a", p.jg, tenant="tiny", max_batch=2)
    p.assert_books_equal()


def test_inflight_quota(graphs):
    p = Pair(graphs, default_quota=TenantQuota(max_inflight=2))
    p.open("g")
    assert p.refuse("levels_batch", "g", [0, 1, 2]) == "inflight"
    got, want = p.both("levels_batch", "g", [0, 1])
    assert len(got) == 2
    assert_same_levels(got, want)
    p.assert_books_equal()


# ---------------------------------------------------------------------------
# byte-budgeted LRU of prepared state
# ---------------------------------------------------------------------------
def test_lru_eviction_under_byte_budget(graphs):
    probe = Pair(graphs)
    js, ts = probe.open("probe")
    cost = session_cost_bytes(ts)
    assert cost == repro.session_cost_bytes(js)

    p = Pair(graphs, byte_budget=int(cost * 2.5))
    p.open("a")
    p.open("b")
    p.both("levels", "a", 0)     # touch a: b becomes the LRU victim
    p.open("c")
    assert "b" not in p.t and "a" in p.t and "c" in p.t
    assert p.t.stats()["evictions"] == 1
    assert p.t.bytes_used() <= p.t.byte_budget
    # evicted session can be re-opened (re-prepared) at any time
    p.open("b")
    assert p.t.stats()["evictions"] == 2
    p.assert_books_equal()


def test_oversized_session_rejected_not_thrashed(graphs):
    p = Pair(graphs, byte_budget=64)
    with pytest.raises(AdmissionError) as ei:
        p.t.open_session("huge", p.tg, max_batch=2,
                         options=repro_torch.PrepareOptions(device="cpu"))
    assert ei.value.reason == "byte-budget"
    assert p.t.stats()["sessions"] == 0
    with pytest.raises(repro.AdmissionError):
        p.j.open_session("huge", p.jg, max_batch=2)
    p.assert_books_equal()


@pytest.mark.parametrize("max_batch,sigma", [(4, 8), (1, 8), (8, 4),
                                             (3, 32)])
def test_session_cost_uses_memory_model(graphs, max_batch, sigma):
    p = Pair(graphs)
    js, ts = p.open("g", max_batch=max_batch, sigma=sigma)
    cost = session_cost_bytes(ts)
    assert cost >= ts.bvss.memory_bytes()["total"]
    assert cost == repro.session_cost_bytes(js)
    assert p.t.bytes_used() == cost
    assert p.t.stats()["tenants"]["default"]["bytes"] == cost
    p.assert_books_equal()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def test_expired_deadline_returns_partial(graphs):
    p = Pair(graphs)
    p.open("g")
    p.t._clock, p.j._clock = stepping_clock(), stepping_clock()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out, want = p.both("levels_batch", "g", [0, 5], deadline_s=0.0)
    assert any(issubclass(x.category, DegradedServiceWarning) for x in w)
    for q, r in zip([0, 5], out):
        assert isinstance(r, TimeoutResult)
        assert not r.complete
        ref = reference_bfs(p.tg, q)
        # partial levels: every computed level matches the oracle...
        got = r.levels != INF
        np.testing.assert_array_equal(r.levels[got], ref[got])
        # ...and the frontier is the oracle's depth-d shell
        np.testing.assert_array_equal(
            np.sort(r.frontier), np.flatnonzero(ref == r.depth))
    assert_same_levels(out, want)
    assert p.t.stats()["timeouts"] == 2
    p.assert_books_equal()


def test_deadline_partial_progress_by_level(paths):
    """A long path graph with a 0s deadline is harvested after ONE
    lock-step level — the documented cancellation granularity."""
    p = Pair(paths)
    p.open("path", order=False)
    p.t._clock, p.j._clock = stepping_clock(), stepping_clock()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        [r], want = p.both("levels_batch", "path", [0], deadline_s=0.0)
    assert isinstance(r, TimeoutResult)
    assert r.depth == 1                       # one level, then harvested
    assert int((r.levels != INF).sum()) == 2  # source + one neighbour
    assert_same_levels([r], want)
    p.assert_books_equal()


@pytest.mark.parametrize("deadline_s", [0.0, 3.0, 7.5])
def test_deadline_harvest_depth_equals_reference(paths, deadline_s):
    """On a clock that advances one second a reading, a deadline of d
    seconds harvests the deep query at the same level in both packages."""
    p = Pair(paths)
    p.open("path", order=False)
    p.t._clock, p.j._clock = stepping_clock(), stepping_clock()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = p.both("levels_batch", "path", [0, 40],
                           deadline_s=deadline_s)
    assert all(isinstance(r, TimeoutResult) for r in got)
    assert_same_levels(got, want)
    p.assert_books_equal()


def test_deadline_raise_mode(graphs):
    p = Pair(graphs)
    p.open("g")
    p.t._clock, p.j._clock = stepping_clock(), stepping_clock()
    with pytest.raises(DeadlineExceeded):
        p.t.levels_batch("g", [0, 5], deadline_s=0.0, on_deadline="raise")
    with pytest.raises(repro.DeadlineExceeded):
        p.j.levels_batch("g", [0, 5], deadline_s=0.0, on_deadline="raise")
    p.assert_books_equal()


def test_generous_deadline_serves_complete(graphs):
    p = Pair(graphs)
    p.open("g")
    out, want = p.both("levels_batch", "g", [0, 5], deadline_s=3600.0)
    for q, lv in zip([0, 5], out):
        assert not isinstance(lv, TimeoutResult)
        np.testing.assert_array_equal(lv, reference_bfs(p.tg, q))
    assert_same_levels(out, want)
    assert p.t.stats()["timeouts"] == 0
    p.assert_books_equal()


def test_deadline_does_not_block_other_queries(paths):
    """One over-deadline deep query is harvested; a shallow query in the
    same wave still completes exactly."""
    p = Pair(paths)
    p.open("path", order=False)
    outs = []
    for mgr in (p.t, p.j):
        clock = {"t": 0.0}
        mgr._clock = lambda c=clock: c["t"]

        # budget 5 "seconds"; each level step costs 1; query 0 (depth 59)
        # must get harvested, query 58 (depth 1) completes within budget
        real = mgr._sessions["path"].session.levels_batch

        def stepping(srcs, real=real, clock=clock, **kw):
            orig_should = kw.get("should_harvest")

            def should(i):
                clock["t"] += 1.0
                return orig_should(i)

            if orig_should is not None:
                kw["should_harvest"] = should
            return real(srcs, **kw)

        mgr._sessions["path"].session.levels_batch = stepping
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs.append(mgr.levels_batch("path", [0, 58], deadline_s=5.0))
    out, want = outs
    assert isinstance(out[0], TimeoutResult)
    np.testing.assert_array_equal(out[1], reference_bfs(p.tg, 58))
    assert_same_levels(out, want)
    p.assert_books_equal()


# ---------------------------------------------------------------------------
# verify-mode sampling / quarantine surface (healthy-path side; the
# fault-injection side lives in tests/test_torch_faults.py)
# ---------------------------------------------------------------------------
def test_verify_sampling_counts(graphs):
    p = Pair(graphs, verify_fraction=1.0)
    p.open("g", max_batch=3)
    p.both("levels_batch", "g", [0, 5, 9])
    st = p.t.stats()
    assert st["verified"] == 3
    assert st["quarantines"] == 0
    p.assert_books_equal()


@pytest.mark.parametrize("fraction,seed", [(0.5, 0), (0.3, 7)])
def test_verify_schedule_equals_reference(graphs, fraction, seed):
    """The sampling RNG is the reference's, draw for draw: the same
    results are verified, in the same order."""
    p = Pair(graphs, verify_fraction=fraction, verify_seed=seed)
    p.open("g", max_batch=3)
    for batch in ([0, 5, 9, 20, 77], [1, 2, 3], [100, 64, 33, 12]):
        p.both("levels_batch", "g", batch)
    assert 0 < p.t.stats()["verified"] < 12
    p.assert_books_equal()


def test_verify_fraction_validated():
    with pytest.raises(ValueError):
        GraphSessionManager(verify_fraction=1.5)
    with pytest.raises(ValueError):
        GraphSessionManager(verify_fraction=-0.1)


def test_close_session(graphs):
    p = Pair(graphs)
    p.open("g")
    p.both("close_session", "g")
    assert "g" not in p.t
    assert p.t.bytes_used() == 0
    with pytest.raises(AdmissionError):
        p.t.levels("g", 0)
    p.assert_books_equal()


def test_events_and_stats_shape(graphs):
    p = Pair(graphs, verify_fraction=1.0)
    p.open("g")
    p.both("levels_batch", "g", [0, 5])
    p.both("close_session", "g")
    kinds = {e["kind"] for e in p.t.events}
    assert {"open", "verify-pass", "close"} <= kinds
    st = p.t.stats()
    for key in ("sessions", "bytes_used", "byte_budget", "evictions",
                "timeouts", "quarantines", "rejections",
                "degraded_serves", "verified", "tenants"):
        assert key in st
    p.assert_books_equal()


# ---------------------------------------------------------------------------
# centrality through the manager, and the verbs of later slices
# ---------------------------------------------------------------------------
def test_centrality_through_manager_matches_reference(graphs):
    p = Pair(graphs)
    p.open("g", max_batch=4)
    srcs = [0, 5, 19, 64]
    bc, jbc = p.both("betweenness", "g", srcs)
    np.testing.assert_allclose(bc, jbc, rtol=1e-4, atol=1e-4)
    cc, jcc = p.both("closeness", "g", srcs)
    np.testing.assert_allclose(cc, jcc, rtol=1e-12)
    assert p.t.stats()["quarantines"] == 0
    p.assert_books_equal()


def test_update_edges_matches_reference(graphs):
    """An update through both managers: the same report, events (the
    ``update-edges`` entry with the reference's fields), ``stats()`` and
    byte cost; the verify oracle follows the mutated graph, so verified
    queries on the new epoch pass; a no-op returns None and logs nothing;
    an unknown name is still an AdmissionError."""
    p = Pair(graphs, verify_fraction=1.0)
    p.open("g", max_batch=3)
    lv0, _ = p.both("levels", "g", 0)
    far = int(np.argmax(lv0 == INF))
    a, b = 5, next(d for d in range(p.tg.n)
                   if d != 5 and d not in p.tg.neighbours(5))
    rep, jrep = p.both("update_edges", "g", inserts=[(0, far), (a, b)],
                       deletes=[(0, int(p.tg.neighbours(0)[0]))])
    import dataclasses
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert p.t.events[-1] == {"kind": "update-edges", "name": "g",
                              "tenant": "default", "path": rep.path,
                              "epoch": 1, "n_inserted": 2, "n_deleted": 1}
    p.assert_books_equal()
    got, want = p.both("levels_batch", "g", [0, 5, 9, 77])
    assert_same_levels(got, want)
    assert got[0][far] == 1
    assert p.t.stats()["quarantines"] == 0
    assert p.t.stats()["verified"] == 5
    assert p.both("update_edges", "g") == (None, None)
    p.assert_books_equal()
    assert p.refuse("update_edges", "nope", inserts=[(0, 1)]) == \
        "unknown-session"


def test_mesh_session_names_its_slice(graphs):
    """``open_session(mesh=)`` passes the mesh to the session (served on
    gloo ranks in ``tests/test_torch_mesh_session.py``); beside
    ``options=`` it is the reference's ConfigError, and nothing is
    admitted, in both packages."""
    jg, g = graphs
    mgr = GraphSessionManager()
    with pytest.raises(ConfigError, match="EITHER"):
        mgr.open_session("m", g, mesh=object(),
                         options=repro_torch.PrepareOptions(device="cpu"))
    assert "m" not in mgr and mgr.stats()["sessions"] == 0
    jm = repro.GraphSessionManager()
    with pytest.raises(repro.ConfigError, match="EITHER"):
        jm.open_session("m", jg, mesh=object(),
                        options=repro.PrepareOptions())
    assert "m" not in jm and jm.stats()["sessions"] == 0
