"""The mesh session of the port on a 1-D mesh (``GraphSession(mesh=)``,
``GraphSessionManager.open_session`` with a mesh, the sharded waves,
Brandes, SSSP and PageRank, the stall seam, ``RequestQueue``) against the
JAX reference.

The cases run once per module on one gloo group of 8 CPU ranks
(``tests/torch_mesh.py``, ``program_session_1d``), on sub-meshes of the
first P ranks, and mirror the reference's mesh cases:

* every one of the seven verbs on a weighted session opened by the
  manager, for P in {1, 2, 8}, against the reference's host oracles and
  its single-device session;
* ``tests/test_distributed.py``'s caller-id contract (P in {2, 8}) and its
  sharded Brandes across device counts (P in {1, 2, 8}; rtol 1e-6 against
  the reference's single-device Brandes, 1e-4 against the oracle);
* ``tests/test_analytics.py``'s two-device parity cases (components,
  betweenness, eccentricity, the σ channel through a refill, closeness);
* ``tests/test_weighted_verbs.py``'s sharded SSSP, PageRank and bad
  weights; ``tests/test_faults.py``'s stalled shard; ``tests/
  test_validation.py``'s degenerate graphs;
* what only SPMD has: a deadline that rank 1 answers differently from
  rank 0 (rank 0's harvest counts on every rank, nothing hangs), and the
  async queue pumped while the ranks submit on their own timing.

Tolerances are the reference tests': levels and integer outputs exact,
closeness rtol 1e-12, betweenness rtol 1e-6 of the single-device answer
and rtol/atol 1e-4 of the oracle, SSSP rtol 1e-6 with equal infinities,
PageRank 1e-6 relative.  Every rank's answers must equal rank 0's.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro
import torch_mesh as tm
from repro.analytics.betweenness import make_betweenness as j_make_bc
from repro.core import BlestProblem as JProblem
from repro.core import build_bvss as jbuild_bvss
from repro.core import reference_bfs as jbfs
from repro.graphs import from_edges as jfrom_edges
from repro.graphs import generators as jgen
from repro.graphs import src_of_edges
from repro.kernels.ref import (betweenness_ref, closeness_ref,
                               connected_components_ref, eccentricity_ref,
                               pagerank_ref, sssp_ref)
from tests.test_analytics import _numpy_sigma
from tests.test_validation import DEGENERATE
from tests.test_weighted_verbs import assert_dist_equal
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def ranks() -> list[dict]:
    """Every rank's results of :func:`torch_mesh.program_session_1d`."""
    return tm.run_ranks(tm.program_session_1d, 8)


# ---------------------------------------------------------------------------
# the seven verbs, P in {1, 2, 8}
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def verbs_reference():
    """The reference's single-device session and oracles of the verbs
    case."""
    jg = jgen.rmat(7, 8, seed=19)
    tm.same_graph(tm.verbs_graph(), jg)
    w = tm.dyadic(np.random.default_rng(20), jg.m)
    sess = repro.GraphSession(jg, max_batch=3, w=256, weights=w)
    return jg, w, sess


@pytest.mark.parametrize("P", tm.SESSION_RANKS)
def test_every_verb_on_a_mesh_equals_reference(ranks, verbs_reference, P):
    jg, w, jsess = verbs_reference
    q = tm.VERB_QUERIES
    got = tm.each_rank(ranks, ("verbs", P), P)
    np.testing.assert_array_equal(got["levels"], jbfs(jg, q[1]))
    for s, lv in zip(q, got["levels_batch"]):
        np.testing.assert_array_equal(lv, jbfs(jg, s), err_msg=f"src {s}")
    np.testing.assert_array_equal(got["components"],
                                  connected_components_ref(jg))
    np.testing.assert_array_equal(got["eccentricity"],
                                  eccentricity_ref(jg.symmetrized, q[:5]))
    np.testing.assert_allclose(got["closeness"], closeness_ref(jg, q[:5]),
                               rtol=1e-12)
    bc = got["betweenness"]
    np.testing.assert_allclose(bc, betweenness_ref(jg, q[:4]), rtol=1e-4,
                               atol=1e-4)
    single = jsess.betweenness_batch(q[:4])
    scale = max(float(np.abs(single).max()), 1.0)
    assert float(np.abs(bc - single).max()) / scale <= 1e-6
    ref = sssp_ref(jg, q[:3], w)
    assert_dist_equal(got["sssp_batch"], ref)
    assert_dist_equal(got["sssp"], sssp_ref(jg, [q[4]], w)[0])
    ref = pagerank_ref(jg)
    rel = np.max(np.abs(got["pagerank"] - ref) / np.maximum(ref, 1e-30))
    assert rel <= 1e-6, rel
    # the manager's books equal the reference's; no replicated problem
    jm = repro.GraphSessionManager()
    jm.open_session("verbs", jg, max_batch=3, w=256, weights=w)
    assert got["bytes"] == jm.bytes_used()
    assert got["problems_sharded"]
    # edge updates on the mesh session (once refused, queue 1 item 11e):
    # through the manager, then a wave, sssp_batch and pagerank on the new
    # epoch, against the reference's single-device session under the same
    # batch
    up = got["update_edges"]
    ins, wi, dels = tm.session_update_batch(tm.verbs_graph())
    jm.open_session("updated", jg, max_batch=3, w=256, weights=w)
    report = jm.update_edges("updated", ins, dels, insert_weights=wi)
    assert up["report"] == dataclasses.asdict(report)
    assert up["epoch"] == 1
    js = jm._sessions["updated"].session
    for lv, want in zip(up["wave"], jm.levels_batch("updated", q)):
        np.testing.assert_array_equal(lv, want)
    assert_dist_equal(up["sssp_batch"], js.sssp_batch(q[:3]))
    want = js.pagerank(tol=1e-10, max_iter=500)
    rel = np.max(np.abs(up["pagerank"] - want) / np.maximum(want, 1e-30))
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("P", tm.SESSION_RANKS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_sharded_betweenness_matches_single_and_oracle(ranks, P,
                                                       use_kernel):
    """``tests/test_distributed.py``: the ragged last shard and an
    isolated-source column, the kernel path and the twins'."""
    jgraphs = [jgen.clustered(3, 23, seed=4),
               jfrom_edges(50, np.array([1, 2, 10]), np.array([2, 3, 11]))]
    for gi, (tg, jg) in enumerate(zip(tm.bc_graphs(), jgraphs)):
        tm.same_graph(tg, jg)
        srcs = tm.bc_sources(jg)
        f1 = j_make_bc(JProblem.build(jbuild_bvss(jg)), len(srcs))
        lv1, sg1, dl1 = [np.asarray(x) for x in f1(jnp.asarray(srcs))]
        lvD, sgD, dlD = tm.each_rank(ranks, ("bc", P, gi, use_kernel), P)
        np.testing.assert_array_equal(lvD, lv1)
        np.testing.assert_allclose(sgD, sg1, rtol=1e-6)
        scale = max(float(np.abs(dl1).max()), 1.0)
        assert float(np.abs(dlD - dl1).max()) / scale <= 1e-6
        np.testing.assert_allclose(dlD.astype(np.float64).sum(axis=1),
                                   betweenness_ref(jg, srcs), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("P", [2, 8])
def test_sharded_graph_session_caller_id_contract(ranks, P):
    """``tests/test_distributed.py``: refills, a duplicate query, mixed
    depths and closeness, all in caller ids, over the mesh."""
    got = tm.each_rank(ranks, ("caller_ids", P), P)
    jg = jgen.rmat(8, 8, seed=1)
    assert got["ordering"] == "jaccard_windows" and got["moved"]
    for s, lv in zip(got["queries"], got["levels"]):
        np.testing.assert_array_equal(lv, jbfs(jg, s), err_msg=f"src {s}")
    g2 = jfrom_edges(60, np.arange(59), np.arange(1, 60))
    for s, lv in zip([58, 0, 55, 2, 59], got["path"]):
        np.testing.assert_array_equal(lv, jbfs(g2, s), err_msg=f"src {s}")
    srcs, cc = got["sample"]
    np.testing.assert_allclose(cc, closeness_ref(jg, srcs), rtol=1e-12)


# ---------------------------------------------------------------------------
# the reference's two-device cases
# ---------------------------------------------------------------------------
def test_sharded_components_and_betweenness_parity(ranks):
    """``tests/test_analytics.py``: components and Brandes on two ranks
    equal the reference's single-device session (betweenness within
    1e-6) and the oracles."""
    got = tm.each_rank(ranks, "parity_rmat")
    jg = jgen.rmat(6, 8, seed=1)
    jsess = repro.GraphSession(jg, max_batch=4)
    np.testing.assert_array_equal(got["components"], jsess.components())
    np.testing.assert_array_equal(got["components"],
                                  connected_components_ref(jg))
    srcs = np.random.default_rng(4).integers(0, jg.n, 4)
    single = jsess.betweenness_batch(srcs)
    scale = max(float(np.abs(single).max()), 1.0)
    assert float(np.abs(got["betweenness"] - single).max()) / scale <= 1e-6
    np.testing.assert_allclose(got["betweenness"], betweenness_ref(jg, srcs),
                               rtol=1e-4, atol=1e-4)


def test_sharded_eccentricity_and_closeness_parity(ranks):
    jg = jgen.grid2d(8, 8, shuffle=True, seed=3)
    srcs = np.random.default_rng(5).integers(0, jg.n, 5)
    np.testing.assert_array_equal(tm.each_rank(ranks, "parity_ecc"),
                                  eccentricity_ref(jg.symmetrized, srcs))
    got = tm.each_rank(ranks, "parity_closeness")
    jg = jgen.clustered(3, 16, seed=4)
    srcs = np.random.default_rng(8).integers(0, jg.n, 5)
    np.testing.assert_allclose(got["sampled"], closeness_ref(jg, srcs),
                               rtol=1e-12)
    np.testing.assert_allclose(got["exact"], closeness_ref(jg), rtol=1e-12)


def test_sharded_sigma_channel_refill_parity(ranks):
    """A two-rank σ engine survives a mid-flight ``insert_batch`` refill
    with exact per-source path counts (read through ``paths_of``)."""
    got = tm.each_rank(ranks, "sigma_refill")
    jg = jgen.rmat(6, 8, seed=3)
    for slot, src in ((0, 23), (1, 9)):
        dist, sig = _numpy_sigma(jg, src)
        reached = dist >= 0
        np.testing.assert_allclose(got[slot][reached], sig[reached],
                                   rtol=1e-5, err_msg=f"slot {slot}")


def test_sharded_weighted_verbs_match_oracle(ranks):
    """``tests/test_weighted_verbs.py``: SSSP and PageRank on two ranks,
    and every bad weight vector a GraphValidationError."""
    jg = jgen.rmat(7, 8, seed=19)
    w = tm.dyadic(np.random.default_rng(20), jg.m)
    assert_dist_equal(tm.each_rank(ranks, "sssp"), sssp_ref(jg, [0, 9], w))
    jg = jgen.rmat(7, 8, seed=21)
    ref = pagerank_ref(jg)
    pr = tm.each_rank(ranks, "pagerank")
    assert np.max(np.abs(pr - ref) / np.maximum(ref, 1e-30)) <= 1e-6
    bad = tm.each_rank(ranks, "bad_weights")
    assert sorted(bad) == ["inf", "nan", "negative", "shape", "zero"]
    for case, msg in bad.items():
        assert msg is not None and \
            msg.startswith("GraphValidationError"), (case, msg)


def test_stalled_shard_caught_and_underdiscovers(ranks):
    """``tests/test_faults.py``: shard 1's frontier words zeroed.  Verified,
    every answer is the oracle's through one quarantine; unverified, the
    stall changes answers."""
    got = tm.each_rank(ranks, "stall_shard")
    jg = jgen.rmat(7, 8, seed=2)
    for s, lv in zip(tm.FAULT_QUERIES, got["verified"]):
        np.testing.assert_array_equal(lv, jbfs(jg, s))
    assert got["degraded"] >= 1
    assert got["stats"]["quarantines"] == 1
    assert sum(not np.array_equal(lv, jbfs(jg, s))
               for s, lv in zip(tm.FAULT_QUERIES, got["unverified"])) > 0


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_degenerate_graphs_mesh(ranks, case):
    """``tests/test_validation.py``: one vertex, no edges, one edge, a
    source in an empty component, on two ranks."""
    jg, sources = DEGENERATE[case]
    tm.same_graph(tm.degenerate_graphs()[case][0], jg)
    got = tm.each_rank(ranks, "degenerate")[case]
    for s, lv in zip(sources, got):
        np.testing.assert_array_equal(lv, jbfs(jg, s), err_msg=f"src {s}")


# ---------------------------------------------------------------------------
# SPMD: rank-uniform decisions
# ---------------------------------------------------------------------------
def test_rank_skewed_deadline_follows_rank_zero(ranks):
    """Rank 0 harvests request 1 at its third offer; rank 1's hook would
    harvest request 0 at once.  Every rank returns rank 0's answers:
    request 1 cancelled with the same partial levels, the rest the
    oracle's, and the wave finishes."""
    got = tm.each_rank(ranks, "skew")
    g2 = jfrom_edges(60, np.arange(59), np.arange(1, 60))
    assert got["levels"][1] is None
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got["levels"][i],
                                      jbfs(g2, tm.SKEW_QUERIES[i]))
    assert list(got["partial"]) == [1]
    want = np.asarray(jbfs(g2, 1))
    part = got["partial"][1]
    depth = int(part[part != INF].max())
    assert 1 <= depth < want[want != INF].max()
    np.testing.assert_array_equal(part, np.where(want <= depth, want, INF))


def test_queue_over_a_mesh_session(ranks):
    """The pump drains a two-rank session while each rank submits on its
    own timing: every future is the oracle's, verified, on every rank,
    and the ranks ran the same waves."""
    got = tm.each_rank(ranks, "queue")
    jg = jgen.rmat(7, 8, seed=2)
    for s, lv in zip(tm.QUEUE_QUERIES, got["levels"]):
        np.testing.assert_array_equal(lv, jbfs(jg, s), err_msg=f"src {s}")
    assert got["stats"]["completed"] == len(tm.QUEUE_QUERIES)
    assert got["stats"]["degraded"] == 0
    assert got["manager"]["quarantines"] == 0
    assert got["manager"]["verified"] == len(tm.QUEUE_QUERIES)


def test_queue_passes_a_mesh_update_through(ranks):
    """``GraphSessionManager.update_edges`` on the queue's mesh session
    between two drains: the report equals the reference's single-device
    one, and the second drain's futures are the updated graph's oracle
    answers, verified, on every rank."""
    got = tm.each_rank(ranks, "queue_update")
    jg = jgen.rmat(7, 8, seed=2)
    jprep = repro.apply_edge_updates(
        repro.prepare(jg), inserts=[tm.missing_edge(jg)])
    assert got["report"] == dataclasses.asdict(jprep.last_update)
    g_now = jfrom_edges(jg.n, jprep.inv[src_of_edges(jprep.graph)],
                        jprep.inv[jprep.graph.indices], dedup=True,
                        drop_loops=False)
    for s, lv in zip(tm.QUEUE_QUERIES[:4], got["levels"]):
        np.testing.assert_array_equal(lv, jbfs(g_now, s), err_msg=f"src {s}")
    assert got["manager"]["quarantines"] == 0
    assert got["manager"]["verified"] == len(tm.QUEUE_QUERIES) + 4


# ---------------------------------------------------------------------------
# benchmarks/bench_dist.py on 2 ranks
# ---------------------------------------------------------------------------
def _keys(d: dict) -> dict:
    """The nested key structure of a JSON object (its values dropped)."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_bench_dist_on_two_ranks_verified(ranks):
    """The port's ``bench_dist`` at scale 6 on 2 gloo ranks: every part
    verified against the oracle on both ranks, with the reference's keys
    (``BENCH_pr10.json``'s ``dist`` block) but for the envelope."""
    got = ranks[0]["bench_dist"]
    assert ranks[1]["bench_dist"]["summary"]["all_verified"]
    assert got["summary"]["all_verified"]
    assert got["devices"] == 2
    ref = json.loads((Path(__file__).resolve().parents[1]
                      / "BENCH_pr10.json").read_text())["dist"]
    assert _keys(got["graphs"]) == _keys(ref["graphs"])
    assert _keys(got["summary"]) == _keys(ref["summary"])
    for gname, row in got["graphs"].items():
        for part in ("engine_dist", "serve_dist", "betweenness_dist"):
            assert row[part]["verified"], (gname, part)


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
@pytest.mark.parametrize("P", tm.FUSED_RANKS)
def test_fused_wave_marks_equal_seam_on_a_mesh(ranks, P, direction):
    """The 1-D wave engine with its marks fused into the bit-SpMM equals
    the same engine through the ``spmm_impl`` seam (local rows, sink row
    ``rows_per_shard``), through a fixed cohort and through ``drive_wave``,
    and the host BFS."""
    got = tm.each_rank(ranks, ("fused", P), P)[direction]
    tm.check_fused_and_seam(got, tm.fused_graph(), tm.VERB_QUERIES,
                            direction)
