"""The fault-injection gauntlet of the port (DESIGN §2.7) against the JAX
package's, on the CPU.

Every case of ``tests/test_faults.py`` runs here on the same numpy-seeded
graph through ``repro.serve`` (its Pallas kernels in interpret mode, as
its own tests run them) and through ``repro_torch.serve`` with
``PrepareOptions(device="cpu")``.  The contract is the reference's: every
injected fault surfaces as a typed error or a degraded-but-correct answer,
never a silent wrong one.  Beyond it, the port must land each fault where
the reference does: with ``direction="pull"`` the unverified faulted
levels under ``corrupt_spmm_tile`` equal the reference's faulted levels
bit for bit, and the manager's events and ``stats()`` equal the
reference's.  On one device neither package consults the ``gather_impl``
seam, so the two stall plans are accepted and inert in both (the mesh
cases: ``tests/test_torch_mesh_session.py``).

Tolerance: levels, ``TimeoutResult`` fields, events and ``stats()``
exactly; betweenness within rtol 1e-4 / atol 1e-4 of the reference's
oracle, and rtol 1e-6 of the port's own (the reference test's bound).
"""
import warnings

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import reference_bfs as jreference_bfs
from repro.graphs import generators as jgen
from repro.kernels.ref import betweenness_ref as jbetweenness_ref
from repro_torch.core import reference_bfs
from repro_torch.errors import AdmissionError, ConfigError, DeadlineExceeded
from repro_torch.graphs import generators as gen
from repro_torch.kernels.ref import betweenness_ref
from repro_torch.serve import (NO_FAULTS, DegradedServiceWarning, FaultPlan,
                               GraphSession, GraphSessionManager,
                               TenantQuota, TimeoutResult)
from torch_one_thread import one_torch_thread  # noqa: F401

QUERIES = [0, 5, 19, 64]
INF = np.int32(np.iinfo(np.int32).max)


@pytest.fixture(scope="module")
def graphs():
    jg, tg = jgen.rmat(7, 8, seed=2), gen.rmat(7, 8, seed=2)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    return jg, tg


def topts(**kw):
    return repro_torch.PrepareOptions(device="cpu", **kw)


def jplan(plan: FaultPlan):
    """The reference's plan with the same fields."""
    return repro.FaultPlan(**{f: getattr(plan, f) for f in (
        "corrupt_spmm_tile", "corrupt_push_tile", "nan_sigma", "stall_shard",
        "stall_butterfly_stage")})


def manager_pair(graphs, name, plan=None, *, verify_fraction=0.0,
                 default_quota=None, **opts):
    """One reference and one port manager, each with session ``name`` over
    the same graph, options and fault plan."""
    jg, tg = graphs
    quota = {} if default_quota is None else dict(
        default_quota=default_quota)
    jm = repro.GraphSessionManager(verify_fraction=verify_fraction,
                                   **({} if default_quota is None else dict(
                                       default_quota=repro.TenantQuota(
                                           **vars(default_quota)))))
    tm = GraphSessionManager(verify_fraction=verify_fraction, **quota)
    max_batch = opts.pop("max_batch", 2)
    jm.open_session(name, jg, max_batch=max_batch,
                    options=repro.PrepareOptions(**opts),
                    fault_plan=None if plan is None else jplan(plan))
    tm.open_session(name, tg, max_batch=max_batch, options=topts(**opts),
                    fault_plan=plan)
    return jm, tm


def assert_oracle(g, out, queries=QUERIES):
    for q, lv in zip(queries, out):
        np.testing.assert_array_equal(lv, reference_bfs(g, q))


def degraded(w) -> bool:
    return any(issubclass(x.category, DegradedServiceWarning) for x in w)


# ---------------------------------------------------------------------------
# plan plumbing
# ---------------------------------------------------------------------------
def test_no_fault_plan_is_free():
    assert not NO_FAULTS.injects
    assert NO_FAULTS.engine_overrides() == {}
    plan = FaultPlan(corrupt_spmm_tile=True)
    assert plan.injects
    assert set(plan.engine_overrides()) == {"spmm_impl"}
    push = FaultPlan(corrupt_push_tile=True)
    assert push.injects
    assert set(push.engine_overrides()) == {"push_impl"}
    assert set(push.engine_overrides(use_kernel=False)) == {"push_impl"}
    both = FaultPlan(nan_sigma=True, stall_shard=1)
    assert set(both.engine_overrides()) == {"spmm_w_impl", "gather_impl"}
    stage = FaultPlan(stall_butterfly_stage=0)
    assert stage.injects
    assert set(stage.engine_overrides()) == {"gather_impl"}
    # the same seams as the reference's plans, for both bases
    for p in (NO_FAULTS, plan, push, both, stage,
              FaultPlan(corrupt_spmm_tile=True, corrupt_push_tile=True,
                        nan_sigma=True)):
        for use_kernel in (True, False):
            assert set(p.engine_overrides(use_kernel=use_kernel)) == set(
                jplan(p).engine_overrides(use_kernel=use_kernel))


def test_double_stall_plan_rejected():
    """``stall_shard`` and ``stall_butterfly_stage`` both occupy the
    ``gather_impl`` seam — a plan setting both is refused at
    construction, in both packages."""
    with pytest.raises(ConfigError, match="gather_impl"):
        FaultPlan(stall_shard=0, stall_butterfly_stage=1)
    with pytest.raises(repro.ConfigError, match="gather_impl"):
        repro.FaultPlan(stall_shard=0, stall_butterfly_stage=1)


@pytest.mark.parametrize("plan", [FaultPlan(stall_shard=1),
                                  FaultPlan(stall_butterfly_stage=0)],
                         ids=["stall-shard", "stall-stage"])
def test_stall_gather_names_the_mesh_slice(plan, monkeypatch):
    """The gather a stall plan wraps is a mesh wave engine's frontier
    exchange, ``gather(words, mesh, axis)``: on a 2-rank mesh (here its
    transfers stubbed: the peer's block is the words + 10) rank 0 receives
    shard 1's segment zeroed, by the flat all-gather (``stall_shard``) and
    by stage 0 of the butterfly (``stall_butterfly_stage``), where the
    unstalled exchange delivers it.  The plans on real gloo ranks:
    ``tests/test_torch_mesh_session.py``."""
    from repro_torch.distributed import bfs_dist, collectives

    class TwoRanks:
        mesh_dim_names, shape = ("data",), (2,)

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    monkeypatch.setattr(bfs_dist, "all_gather_tiled",
                        lambda x, group: torch.cat([x, x + 10]))
    monkeypatch.setattr(collectives, "_exchange",
                        lambda send, peer, group: send + 10)
    monkeypatch.setattr(collectives, "_partner", lambda group, idx, bit: 1)
    words = torch.arange(1, 5, dtype=torch.int32)
    gather = plan.engine_overrides()["gather_impl"]
    got = gather(words, TwoRanks(), "data")
    np.testing.assert_array_equal(got.numpy(), [1, 2, 3, 4, 0, 0, 0, 0])
    clean = bfs_dist.frontier_all_gather(words, TwoRanks(), "data")
    np.testing.assert_array_equal(clean.numpy(),
                                  [1, 2, 3, 4, 11, 12, 13, 14])


def test_faulted_session_actually_diverges(graphs):
    """Sanity for the gauntlet itself: the corrupt-tile fault DOES change
    answers (otherwise scenario 1 would be vacuous)."""
    _, g = graphs
    sess = GraphSession(g, max_batch=2, options=topts(),
                        fault_plan=FaultPlan(corrupt_spmm_tile=True))
    diverged = sum(
        not np.array_equal(lv, reference_bfs(g, q))
        for q, lv in zip(QUERIES, sess.levels_batch(QUERIES)))
    assert diverged > 0


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel-entry", "twin"])
def test_faulted_levels_equal_the_reference_faults(graphs, use_kernel):
    """With ``direction="pull"`` the port queues the wave's tiles in the
    reference's order, so the corrupted tile 0 is the same tile and the
    wrong answers are the same, bit for bit."""
    jg, tg = graphs
    plan = FaultPlan(corrupt_spmm_tile=True)
    js = repro.GraphSession(jg, max_batch=2, direction="pull",
                            use_kernel=use_kernel, fault_plan=jplan(plan))
    ts = GraphSession(tg, max_batch=2, fault_plan=plan,
                      options=topts(direction="pull",
                                    use_kernels=use_kernel))
    want = js.levels_batch(QUERIES)
    got = ts.levels_batch(QUERIES)
    assert any(not np.array_equal(w, jreference_bfs(jg, q))
               for q, w in zip(QUERIES, want))
    for q, g_lv, w_lv in zip(QUERIES, got, want):
        np.testing.assert_array_equal(g_lv, w_lv, err_msg=f"source {q}")


# ---------------------------------------------------------------------------
# scenario 1: corrupted bit-SpMM tile
# ---------------------------------------------------------------------------
def test_corrupt_tile_quarantined_and_reserved_correctly(graphs):
    jm, mgr = manager_pair(graphs, "bad", FaultPlan(corrupt_spmm_tile=True),
                           verify_fraction=1.0)
    _, g = graphs
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = mgr.levels_batch("bad", QUERIES)
    # caller still gets CORRECT levels (reference re-serve) ...
    assert_oracle(g, out)
    # ... with a structured warning and a quarantine on the books
    assert degraded(w)
    st = mgr.stats()
    assert st["quarantines"] == 1
    assert st["degraded_serves"] >= 1
    rec = mgr._sessions["bad"]
    assert rec.quarantined and "diverge" in rec.quarantine_reason
    # subsequent calls skip the faulty engine entirely
    assert_oracle(g, mgr.levels_batch("bad", QUERIES))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm.levels_batch("bad", QUERIES)
        jm.levels_batch("bad", QUERIES)
    assert mgr.stats() == jm.stats()
    assert mgr.events == jm.events


def test_unverified_faulty_session_is_the_counterfactual(graphs):
    """verify_fraction=0 knowingly serves the corruption — documenting
    that the sampling policy (not luck) is what closes the hole."""
    jm, mgr = manager_pair(graphs, "bad", FaultPlan(corrupt_spmm_tile=True))
    _, g = graphs
    out = mgr.levels_batch("bad", QUERIES)
    assert any(not np.array_equal(lv, reference_bfs(g, q))
               for q, lv in zip(QUERIES, out))
    assert mgr.stats()["quarantines"] == 0
    jm.levels_batch("bad", QUERIES)
    assert mgr.stats() == jm.stats()


# ---------------------------------------------------------------------------
# scenario 2: NaN-poisoned sigma channel (weighted Brandes path)
# ---------------------------------------------------------------------------
def test_nan_sigma_degrades_betweenness_to_oracle(graphs):
    jm, mgr = manager_pair(graphs, "poisoned", FaultPlan(nan_sigma=True))
    jg, g = graphs
    srcs = [0, 5, 19]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        bc = mgr.betweenness("poisoned", srcs)
    assert np.isfinite(bc).all()
    np.testing.assert_allclose(bc, betweenness_ref(g, srcs), rtol=1e-6)
    np.testing.assert_allclose(bc, jbetweenness_ref(jg, srcs), rtol=1e-4,
                               atol=1e-4)
    assert degraded(w)
    st = mgr.stats()
    assert st["quarantines"] == 1
    assert "σ" in mgr._sessions["poisoned"].quarantine_reason
    # the quarantine also protects the plain level verbs afterwards
    assert_oracle(g, mgr.levels_batch("poisoned", QUERIES))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm.betweenness("poisoned", srcs)
        jm.levels_batch("poisoned", QUERIES)
    assert mgr.stats() == jm.stats()
    assert mgr.events == jm.events


def test_nan_sigma_fault_actually_poisons(graphs):
    """The poisoned scores sit where the reference's do: the seam is the
    same tile product."""
    jg, g = graphs
    sess = GraphSession(g, max_batch=2, options=topts(),
                        fault_plan=FaultPlan(nan_sigma=True))
    bc = sess.betweenness_batch([0, 5])
    assert not np.isfinite(bc).all()
    js = repro.GraphSession(jg, max_batch=2,
                            fault_plan=repro.FaultPlan(nan_sigma=True))
    want = js.betweenness_batch([0, 5])
    np.testing.assert_array_equal(np.isnan(bc), np.isnan(want))


# ---------------------------------------------------------------------------
# scenario 3: the stall plans (mesh seams) — accepted and inert on one
# device, in both packages
# ---------------------------------------------------------------------------
STALLS = [FaultPlan(stall_shard=1), FaultPlan(stall_butterfly_stage=0)]
STALL_IDS = ["stall-shard", "stall-stage"]


@pytest.mark.parametrize("plan", STALLS, ids=STALL_IDS)
def test_stall_plan_inert_under_verification(graphs, plan):
    """Under full verification a one-device session with a stall plan
    serves oracle-exact levels, never quarantines, and keeps the
    reference's books."""
    jm, mgr = manager_pair(graphs, "stalled", plan, verify_fraction=1.0)
    _, g = graphs
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = mgr.levels_batch("stalled", QUERIES)
    assert_oracle(g, out)
    assert not degraded(w)
    assert mgr.stats()["quarantines"] == 0
    assert mgr.stats()["verified"] == len(QUERIES)
    jm.levels_batch("stalled", QUERIES)
    assert mgr.stats() == jm.stats()
    assert mgr.events == jm.events


@pytest.mark.parametrize("plan", STALLS, ids=STALL_IDS)
def test_stall_plan_session_equals_reference(graphs, plan):
    """The session with the stall plan equals the reference's session
    with it (and the oracle): no engine consults the gather seam here."""
    jg, tg = graphs
    ts = GraphSession(tg, max_batch=2, options=topts(), fault_plan=plan)
    js = repro.GraphSession(jg, max_batch=2, fault_plan=jplan(plan))
    got = ts.levels_batch(QUERIES)
    for q, g_lv, w_lv in zip(QUERIES, got, js.levels_batch(QUERIES)):
        np.testing.assert_array_equal(g_lv, w_lv)
        np.testing.assert_array_equal(g_lv, reference_bfs(tg, q))


# ---------------------------------------------------------------------------
# scenario 4: over-quota request is refused, not queued
# ---------------------------------------------------------------------------
def test_over_quota_rejected_with_reason(graphs):
    jm, mgr = manager_pair(graphs, "g", default_quota=TenantQuota(
        max_sessions=1, max_inflight=2))
    jg, g = graphs
    with pytest.raises(AdmissionError) as ei:
        mgr.open_session("g2", g, max_batch=2, options=topts())
    assert ei.value.reason == "tenant-sessions"
    with pytest.raises(AdmissionError) as ei:
        mgr.levels_batch("g", [0, 1, 2])
    assert ei.value.reason == "inflight"
    # the session itself is untouched by the rejections
    np.testing.assert_array_equal(mgr.levels("g", 0), reference_bfs(g, 0))
    with pytest.raises(repro.AdmissionError):
        jm.open_session("g2", jg, max_batch=2)
    with pytest.raises(repro.AdmissionError):
        jm.levels_batch("g", [0, 1, 2])
    jm.levels("g", 0)
    assert mgr.stats() == jm.stats()
    assert mgr.events == jm.events


# ---------------------------------------------------------------------------
# scenario 5: expired deadline degrades, never hangs
# ---------------------------------------------------------------------------
def stepping_clock():
    """A clock that advances one second a reading: a deadline of 0 s
    harvests every query at its first offer, in both packages alike."""
    t = {"now": 0.0}

    def clock():
        t["now"] += 1.0
        return t["now"]

    return clock


def test_expired_deadline_partial_or_typed_error(graphs):
    jm, mgr = manager_pair(graphs, "g")
    _, g = graphs
    jm._clock, mgr._clock = stepping_clock(), stepping_clock()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = mgr.levels_batch("g", QUERIES, deadline_s=0.0)
        want = jm.levels_batch("g", QUERIES, deadline_s=0.0)
    assert degraded(w)
    for q, r, jr in zip(QUERIES, out, want):
        assert isinstance(r, TimeoutResult) and not r.complete
        ref = reference_bfs(g, q)
        got = r.levels != INF
        # the partial prefix is still oracle-exact
        np.testing.assert_array_equal(r.levels[got], ref[got])
        # and the very partial the reference harvests
        assert (r.source, r.depth, r.deadline_s) == \
            (jr.source, jr.depth, jr.deadline_s)
        np.testing.assert_array_equal(r.levels, jr.levels)
        np.testing.assert_array_equal(r.frontier, jr.frontier)
    with pytest.raises(DeadlineExceeded):
        mgr.levels_batch("g", QUERIES, deadline_s=0.0, on_deadline="raise")
    with pytest.raises(repro.DeadlineExceeded):
        jm.levels_batch("g", QUERIES, deadline_s=0.0, on_deadline="raise")
    assert mgr.stats() == jm.stats()
    assert mgr.events == jm.events


# ---------------------------------------------------------------------------
# scenario 6: corrupted push tile (hybrid direction, DESIGN §2.8)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["twin", "kernel-entry"])
def test_corrupt_push_fault_actually_diverges(graphs, use_kernel):
    """Sanity: under ``direction="push"`` every level runs the push
    seam, so the corrupt tile DOES change answers — the same wrong
    answers as the reference's (the seam's first queued pair is the
    same), through the twin and through the kernel entry point."""
    jg, g = graphs
    plan = FaultPlan(corrupt_push_tile=True)
    sess = GraphSession(g, fault_plan=plan, options=topts(
        use_kernels=use_kernel, direction="push"))
    js = repro.GraphSession(jg, use_kernel=False, direction="push",
                            fault_plan=jplan(plan))
    got = [sess.levels(q) for q in QUERIES]
    diverged = sum(not np.array_equal(lv, reference_bfs(g, q))
                   for q, lv in zip(QUERIES, got))
    assert diverged > 0
    for q, lv in zip(QUERIES, got):
        np.testing.assert_array_equal(lv, js.levels(q))


def test_corrupt_push_invisible_on_pull_levels(graphs):
    """The push fault must NOT leak into pull traffic: a pull-forced
    session built with the same plan stays oracle-exact."""
    _, g = graphs
    sess = GraphSession(g, options=topts(use_kernels=False,
                                         direction="pull"),
                        fault_plan=FaultPlan(corrupt_push_tile=True))
    for q in QUERIES:
        np.testing.assert_array_equal(sess.levels(q), reference_bfs(g, q))


def test_corrupt_push_quarantined_and_reserved_correctly(graphs):
    """Full gauntlet: singleton queries ride the push seam, the verify
    sampler catches the divergence, the session quarantines and every
    answer the caller sees is oracle-exact."""
    jm, mgr = manager_pair(graphs, "pushy", FaultPlan(corrupt_push_tile=True),
                           verify_fraction=1.0, max_batch=8,
                           use_kernels=False, direction="push")
    _, g = graphs
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = [mgr.levels("pushy", q) for q in QUERIES]
        for q in QUERIES:
            jm.levels("pushy", q)
    assert_oracle(g, out)
    assert degraded(w)
    st = mgr.stats()
    assert st["quarantines"] == 1
    assert mgr._sessions["pushy"].quarantined
    assert st == jm.stats()
    assert mgr.events == jm.events


# ---------------------------------------------------------------------------
# the gauntlet property: zero silent wrong answers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan", [
    FaultPlan(corrupt_spmm_tile=True),
    FaultPlan(nan_sigma=True),
], ids=["corrupt-tile", "nan-sigma"])
def test_no_silent_wrong_answers(graphs, plan):
    """Under full verification every COMPLETE answer the manager returns
    equals the oracle, fault or no fault — the central robustness claim."""
    _, g = graphs
    mgr = GraphSessionManager(verify_fraction=1.0)
    mgr.open_session("s", g, max_batch=2, options=topts(), fault_plan=plan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradedServiceWarning)
        levels = mgr.levels_batch("s", QUERIES)
        bc = mgr.betweenness("s", QUERIES)
    for q, lv in zip(QUERIES, levels):
        if isinstance(lv, TimeoutResult):
            continue
        np.testing.assert_array_equal(lv, reference_bfs(g, q))
    assert np.isfinite(bc).all()
    np.testing.assert_allclose(bc, betweenness_ref(g, QUERIES), rtol=1e-6)
