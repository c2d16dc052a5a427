"""RequestQueue / WaveScheduler of the port against the JAX package's, on
the CPU: non-blocking submits with future resolution, mid-flight wave
coalescing, tenant-fair slot hand-out under quota pressure, bounded ingress
(global and per-tenant backlog), deadline harvests into partial
TimeoutResults, the background pump, and draining under injected faults
(degraded-but-correct, never wrong) or a vanished session (futures fail
loudly, never dangle).

Every case of ``tests/test_queue.py`` runs here on the same numpy-seeded
graph through ``repro.serve`` (its Pallas kernels in interpret mode) and
through ``repro_torch.serve`` with ``PrepareOptions(device="cpu")``.  Where
both queues are drained the same way, the port's futures, ``stats()`` and
events equal the reference's exactly (a case that depends on time runs on
an injected clock).  An edge update between drains serves the new epoch,
as in the reference; one from another thread waits for the pump's wave.
A stress case drives the pump with more submitting threads than
cores under a shortened switch interval.
"""
import os
import sys
import threading
import warnings

import numpy as np
import pytest

import repro
import repro_torch
from repro.graphs import generators as jgen
from repro_torch.core import reference_bfs
from repro_torch.errors import QueueFullError
from repro_torch.graphs import generators as gen
from repro_torch.kernels import _build
from repro_torch.serve import (FaultPlan, GraphSessionManager, RequestQueue,
                               TenantQuota, TimeoutResult)
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def graphs():
    return jgen.rmat(7, 8, seed=5), gen.rmat(7, 8, seed=5)


@pytest.fixture(scope="module")
def refs(graphs):
    _, g = graphs
    return {s: reference_bfs(g, s) for s in range(g.n)}


def topts():
    return repro_torch.PrepareOptions(device="cpu", w=512)


class Pair:
    """A reference and a port manager with the same sessions, and a queue
    over each, driven call for call."""

    def __init__(self, graphs, sessions=(("g", "default", 4),), *,
                 queue_kwargs=None, plan=None, **mgr_kwargs):
        jg, tg = graphs
        quota = mgr_kwargs.pop("default_quota", None)
        self.jm = repro.GraphSessionManager(**mgr_kwargs, **(
            {} if quota is None else
            {"default_quota": repro.TenantQuota(**vars(quota))}))
        self.tm = GraphSessionManager(**mgr_kwargs, **(
            {} if quota is None else {"default_quota": quota}))
        jplan = None if plan is None else repro.FaultPlan(
            corrupt_spmm_tile=plan.corrupt_spmm_tile)
        for name, tenant, max_batch in sessions:
            self.jm.open_session(name, jg, tenant=tenant,
                                 max_batch=max_batch,
                                 options=repro.PrepareOptions(w=512),
                                 fault_plan=jplan)
            self.tm.open_session(name, tg, tenant=tenant,
                                 max_batch=max_batch, options=topts(),
                                 fault_plan=plan)
        kw = queue_kwargs or {}
        self.jq = repro.RequestQueue(self.jm, **kw)
        self.q = RequestQueue(self.tm, **kw)

    def submit(self, *args, **kwargs):
        """Submit to both queues; the port's future and the reference's."""
        return self.q.submit(*args, **kwargs), self.jq.submit(*args, **kwargs)

    def drain(self, **kwargs):
        n, jn = self.q.drain(**kwargs), self.jq.drain(**kwargs)
        assert n == jn
        return n

    def assert_books_equal(self):
        assert self.q.stats() == self.jq.stats()
        assert self.q.events == self.jq.events
        assert self.tm.stats() == self.jm.stats()
        assert self.tm.events == self.jm.events


def assert_same_result(got, want):
    if isinstance(want, repro.TimeoutResult):
        assert isinstance(got, TimeoutResult)
        assert (got.source, got.depth, got.deadline_s) == \
            (want.source, want.depth, want.deadline_s)
        np.testing.assert_array_equal(got.levels, want.levels)
        np.testing.assert_array_equal(got.frontier, want.frontier)
    else:
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _mgr(graphs, name="g", *, tenant="default", verify_fraction=0.0,
         max_batch=4, **mgr_kwargs):
    _, g = graphs
    mgr = GraphSessionManager(verify_fraction=verify_fraction, **mgr_kwargs)
    mgr.open_session(name, g, tenant=tenant, max_batch=max_batch,
                     options=topts())
    return mgr


# ---------------------------------------------------------------------------
# basic contract: submit is non-blocking, drain resolves every future
# ---------------------------------------------------------------------------
def test_submit_drain_resolves_correct_levels(graphs, refs):
    p = Pair(graphs)
    srcs = [0, 3, 9, 27, 50, 81, 100, 5]
    futs = [p.submit("g", s) for s in srcs]
    assert not any(f.done() for f, _ in futs)     # nothing ran yet
    n = p.drain()
    assert n == len(srcs)
    for s, (f, jf) in zip(srcs, futs):
        assert f.done() and f.exception(0) is None
        np.testing.assert_array_equal(f.result(0), refs[s])
        assert_same_result(f.result(0), jf.result(0))
    st = p.q.stats()
    assert st["submitted"] == st["completed"] == len(srcs)
    assert st["pending"] == 0 and st["timeouts"] == 0
    # 8 requests through a 4-slot pool: later arrivals joined in-flight
    # waves (the whole point of the queue)
    assert st["coalesced"] > 0
    assert st["waves"] >= 1
    p.assert_books_equal()


def test_same_source_twice_resolves_both(graphs, refs):
    q = RequestQueue(_mgr(graphs))
    f1, f2 = q.submit("g", 7), q.submit("g", 7)
    q.drain()
    np.testing.assert_array_equal(f1.result(0), refs[7])
    np.testing.assert_array_equal(f2.result(0), refs[7])


def test_submit_validates_at_ingress(graphs):
    _, g = graphs
    q = RequestQueue(_mgr(graphs))
    with pytest.raises(Exception):      # bad source: rejected at submit,
        q.submit("g", g.n + 5)          # not at drain
    with pytest.raises(Exception):      # unknown session
        q.submit("nope", 0)
    assert q.pending == 0


# ---------------------------------------------------------------------------
# bounded ingress
# ---------------------------------------------------------------------------
def test_capacity_rejects_with_reason(graphs):
    p = Pair(graphs, queue_kwargs=dict(capacity=3))
    for s in range(3):
        p.submit("g", s)
    with pytest.raises(QueueFullError) as ei:
        p.q.submit("g", 4)
    assert ei.value.reason == "capacity"
    with pytest.raises(repro.QueueFullError):
        p.jq.submit("g", 4)
    assert p.q.stats()["rejected"] == 1
    p.drain()                            # backlog still serves fine
    assert p.q.pending == 0
    p.assert_books_equal()


def test_tenant_backlog_rejects_only_the_hog(graphs):
    p = Pair(graphs, (("a", "acme", 2), ("b", "beta", 2)),
             queue_kwargs=dict(tenant_backlog=2))
    p.submit("a", 0, tenant="acme")
    p.submit("a", 1, tenant="acme")
    with pytest.raises(QueueFullError) as ei:
        p.q.submit("a", 2, tenant="acme")
    assert ei.value.reason == "tenant-backlog"
    with pytest.raises(repro.QueueFullError):
        p.jq.submit("a", 2, tenant="acme")
    # the other tenant is unaffected by acme's full backlog
    f, _ = p.submit("b", 3, tenant="beta")
    p.drain()
    assert f.done()
    p.assert_books_equal()


# ---------------------------------------------------------------------------
# fairness under quota pressure
# ---------------------------------------------------------------------------
def test_tenant_fair_slot_handout_under_inflight_quota(graphs, refs):
    """max_inflight=1 caps a tenant at one slot at a time: its backlog
    serializes (slots never overlap, so nothing coalesces) instead of
    monopolising the 4-wide pool — and still completes correctly."""
    p = Pair(graphs, (("s", "hog", 4),),
             default_quota=TenantQuota(max_inflight=1))
    futs = [p.submit("s", s, tenant="hog") for s in range(6)]
    n = p.drain()
    assert n == 6
    # one slot at a time: no request ever joined an in-flight wave
    assert p.q.stats()["coalesced"] == 0
    for s, (f, jf) in zip(range(6), futs):
        np.testing.assert_array_equal(f.result(0), refs[s])
        assert_same_result(f.result(0), jf.result(0))
    p.assert_books_equal()


def test_two_tenants_capped_and_coalescing(graphs, refs):
    """Two tenants, each on its own session (a session belongs to one
    tenant), each capped at two of four slots, with staggered arrivals:
    every future is the oracle's, requests coalesce into waves in flight,
    and the hand-out order (hence every wave's make-up and the books) is
    the reference's."""
    t = {"now": 0.0}
    p = Pair(graphs, (("a", "acme", 4), ("b", "beta", 4)),
             default_quota=TenantQuota(max_inflight=2),
             queue_kwargs=dict(clock=lambda: t["now"]))
    futs = [(s, p.submit("a" if s % 2 else "b", s,
                         tenant="acme" if s % 2 else "beta",
                         not_before=float(s // 4)))
            for s in range(12)]
    for now in (0.0, 1.0, 2.0):
        t["now"] = now
        p.drain()
    for s, (f, jf) in futs:
        np.testing.assert_array_equal(f.result(0), refs[s])
        assert_same_result(f.result(0), jf.result(0))
    assert p.q.stats()["coalesced"] > 0
    p.assert_books_equal()


def test_multi_session_drain_is_round_robin_not_starving(graphs, refs):
    """drain() serves every session with eligible work each pass — a
    session with a standing backlog cannot starve a later-registered
    one."""
    p = Pair(graphs, (("first", "default", 2), ("second", "default", 2)))
    fa = [p.submit("first", s) for s in range(5)]
    fb = [p.submit("second", s) for s in range(5)]
    p.drain()
    for s, (f, jf) in zip(range(5), fa):
        np.testing.assert_array_equal(f.result(0), refs[s])
        assert_same_result(f.result(0), jf.result(0))
    for s, (f, jf) in zip(range(5), fb):
        np.testing.assert_array_equal(f.result(0), refs[s])
        assert_same_result(f.result(0), jf.result(0))
    p.assert_books_equal()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def test_deadline_harvests_partial_timeout_result(graphs):
    """A clock that jumps past the deadline mid-wave forces the harvest
    path: the future resolves to a partial TimeoutResult whose computed
    prefix MATCHES the oracle (partial, never wrong) — the very partial
    the reference harvests."""
    _, g = graphs
    t = {"now": 0.0}
    p = Pair(graphs, queue_kwargs=dict(clock=lambda: t["now"]))

    fut, jfut = p.submit("g", 0, deadline_s=5.0)
    t["now"] = 10.0                      # deadline long gone before drain
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p.drain()
    res = fut.result(0)
    assert isinstance(res, TimeoutResult)
    assert res.complete is False and res.source == 0
    ref = reference_bfs(g, 0)
    got = res.levels
    assert (got != INF).any() and (got == INF).any()   # genuinely partial
    mask = got != INF
    np.testing.assert_array_equal(got[mask], ref[mask])
    assert p.q.stats()["timeouts"] == 1
    assert_same_result(res, jfut.result(0))
    p.assert_books_equal()


def test_generous_deadline_completes_normally(graphs, refs):
    q = RequestQueue(_mgr(graphs))
    fut = q.submit("g", 11, deadline_s=3600.0)
    q.drain()
    np.testing.assert_array_equal(fut.result(0), refs[11])
    assert q.stats()["timeouts"] == 0


# ---------------------------------------------------------------------------
# not_before (simulated arrivals) + background pump
# ---------------------------------------------------------------------------
def test_not_before_holds_request_until_due(graphs, refs):
    t = {"now": 0.0}
    p = Pair(graphs, queue_kwargs=dict(clock=lambda: t["now"]))
    fut, jfut = p.submit("g", 2, not_before=100.0)
    p.drain()                            # not due yet: nothing served
    assert not fut.done() and p.q.pending == 1
    t["now"] = 100.0
    p.drain()
    np.testing.assert_array_equal(fut.result(0), refs[2])
    assert_same_result(fut.result(0), jfut.result(0))
    p.assert_books_equal()


def test_background_pump_resolves_without_explicit_drain(graphs, refs):
    q = RequestQueue(_mgr(graphs))
    q.start(poll_s=0.001)
    try:
        futs = [q.submit("g", s) for s in (1, 2, 3)]
        for s, f in zip((1, 2, 3), futs):
            np.testing.assert_array_equal(f.result(10.0), refs[s])
    finally:
        q.stop()
    assert q.pending == 0


def test_submit_from_other_threads_is_safe(graphs, refs):
    q = RequestQueue(_mgr(graphs, max_batch=8))
    out: list = []

    def client(lo):
        fs = [q.submit("g", s) for s in range(lo, lo + 4)]
        out.append((lo, fs))

    threads = [threading.Thread(target=client, args=(lo,))
               for lo in (0, 10, 20)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30.0)
        assert not th.is_alive()
    q.drain()
    for lo, fs in out:
        for s, f in zip(range(lo, lo + 4), fs):
            np.testing.assert_array_equal(f.result(0), refs[s])


def test_pump_under_thread_pressure(graphs, refs):
    """More submitting threads than cores, a shortened switch interval and
    the pump running: every future resolves to its oracle, the books add
    up, and the launch count lost no update to the races."""
    q = RequestQueue(_mgr(graphs, max_batch=8))
    n_threads = 2 * (os.cpu_count() or 2) + 2
    per_thread = 5
    out: list = []
    lock = threading.Lock()

    def client(k):
        fs = [(s, q.submit("g", s)) for s in
              ((k * 7 + i) % 128 for i in range(per_thread))]
        with lock:
            out.extend(fs)

    def counter(entry):
        for _ in range(200):
            _build.count(entry)

    class Entry:
        launches = 0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    q.start(poll_s=0.001)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_threads)]
        threads += [threading.Thread(target=counter, args=(Entry,))
                    for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
            assert not th.is_alive()
        for s, f in out:
            np.testing.assert_array_equal(f.result(60.0), refs[s])
    finally:
        sys.setswitchinterval(interval)
        q.stop()
    assert len(out) == n_threads * per_thread
    st = q.stats()
    assert st["submitted"] == st["completed"] == len(out)
    assert st["pending"] == 0
    assert Entry.launches == 200 * n_threads


# ---------------------------------------------------------------------------
# fault gauntlet: drain degrades, never lies, never dangles
# ---------------------------------------------------------------------------
def test_faulty_session_drains_degraded_but_correct(graphs, refs):
    """verify_fraction=1 + corrupted SpMM tile: the queue's post-wave
    verify quarantines the session and every future resolves on the
    reference path — correct answers, degraded stats on the books, the
    reference's books."""
    p = Pair(graphs, (("bad", "default", 2),), verify_fraction=1.0,
             plan=FaultPlan(corrupt_spmm_tile=True))
    srcs = [0, 3, 9, 27]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # DegradedServiceWarning expected
        futs = [p.submit("bad", s) for s in srcs]
        p.drain()
    for s, (f, _) in zip(srcs, futs):
        np.testing.assert_array_equal(f.result(0), refs[s])
    assert p.tm.stats()["quarantines"] == 1
    assert p.q.stats()["degraded"] > 0
    # the NEXT batch short-circuits to the reference path (quarantined)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f2, _ = p.submit("bad", 5)
        p.drain()
    np.testing.assert_array_equal(f2.result(0), refs[5])
    p.assert_books_equal()


def test_closed_session_rejects_backlog_loudly(graphs):
    mgr = _mgr(graphs)
    q = RequestQueue(mgr)
    futs = [q.submit("g", s) for s in (0, 1, 2)]
    mgr.close_session("g")
    q.drain()
    for f in futs:
        assert f.done()
        assert f.exception(0) is not None
        with pytest.raises(Exception):
            f.result(0)
    assert q.pending == 0


def test_future_result_timeout_raises_but_request_survives(graphs, refs):
    q = RequestQueue(_mgr(graphs))
    fut = q.submit("g", 4)
    with pytest.raises(TimeoutError):
        fut.result(0.001)                # nothing drained it yet
    q.drain()
    np.testing.assert_array_equal(fut.result(0), refs[4])


def test_stats_and_events_schema(graphs):
    p = Pair(graphs)
    p.submit("g", 0)
    p.drain()
    st = p.q.stats()
    for k in ("submitted", "completed", "timeouts", "degraded", "rejected",
              "coalesced", "waves", "pending"):
        assert k in st, k
    assert st["submitted"] == st["completed"] == 1
    p.assert_books_equal()


# ---------------------------------------------------------------------------
# epoch interplay: updates between waves keep serving current answers
# ---------------------------------------------------------------------------
def test_queue_serves_post_update_epoch(graphs, refs):
    """An edge update between drains swaps the prepared epoch; queued
    queries after the swap see the NEW graph — in both packages, with
    every answer verified and the same books."""
    p = Pair(graphs, verify_fraction=1.0)
    src = 0
    f0, jf0 = p.submit("g", src)
    p.drain()
    lv_before = f0.result(0)
    np.testing.assert_array_equal(lv_before, refs[src])
    assert_same_result(lv_before, jf0.result(0))

    # add an edge from src to an unreached vertex
    far = int(np.argmax(lv_before == INF))
    assert lv_before[far] == INF
    report = p.tm.update_edges("g", inserts=[(src, far)])
    jreport = p.jm.update_edges("g", inserts=[(src, far)])
    assert report is not None and report.epoch == jreport.epoch == 1

    f1, jf1 = p.submit("g", src)
    p.drain()
    lv_after = f1.result(0)
    assert lv_after[far] == 1            # the new edge is live
    assert_same_result(lv_after, jf1.result(0))
    assert p.tm.stats()["quarantines"] == 0
    p.assert_books_equal()


def test_update_waits_for_the_pump_wave(graphs):
    """Edge updates from the main thread while more submitting threads
    than cores feed the pump, under a shortened switch interval: each
    update lands between waves (the manager's serving lock), so verify
    mode never holds one epoch's answer against another epoch's graph —
    no quarantine, and every future is the oracle's answer on some
    epoch."""
    from repro_torch import from_edges, src_of_edges
    mgr = _mgr(graphs, verify_fraction=1.0, max_batch=2)
    sess = mgr._sessions["g"].session
    q = RequestQueue(mgr)

    def caller_graph():
        p = sess.prepared
        return from_edges(p.graph.n, p.inv[src_of_edges(p.graph)],
                          p.inv[p.graph.indices])

    epochs = [caller_graph()]
    rng = np.random.default_rng(8)
    n_threads = 2 * (os.cpu_count() or 2) + 2
    futs: list = []
    lock = threading.Lock()

    def client(k):
        fs = [q.submit("g", (k * 11 + i) % sess.n) for i in range(3)]
        with lock:
            futs.extend(fs)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    q.start(poll_s=0.0005)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for _ in range(3):
            a, b = rng.integers(0, sess.n, 2)
            while a == b or b in epochs[-1].neighbours(int(a)):
                a, b = rng.integers(0, sess.n, 2)
            mgr.update_edges("g", inserts=[(int(a), int(b))])
            epochs.append(caller_graph())
        for th in threads:
            th.join(60.0)
            assert not th.is_alive()
        for f in futs:
            lv = f.result(60.0)
            assert any(np.array_equal(lv, reference_bfs(g, f.source))
                       for g in epochs), f.source
    finally:
        q.stop()
        sys.setswitchinterval(interval)
    assert len(futs) == 3 * n_threads
    assert mgr.stats()["quarantines"] == 0
    assert sess.epoch == len(epochs) - 1 == 3
