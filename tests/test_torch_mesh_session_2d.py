"""The mesh session of the port on a 2-D ``("data", "col")`` mesh against
the JAX reference.

The cases run once per module on one gloo group of 8 CPU ranks
(``tests/torch_mesh.py``, ``program_session_2d``) and mirror the
reference's 2-D mesh cases:

* ``tests/test_distributed_2d.py::test_2d_session_transparency_and_sigma_parity``
  on (2, 2) and (4, 2), and on (1, 1): the wave levels bit for bit,
  betweenness within rtol 1e-6 of the oracle and of the reference's
  single-device session, components equal to it; with every other verb
  the reference serves on a 2-D mesh (``levels``, ``eccentricity``,
  ``closeness``), and ``sssp``/``pagerank`` raising its ConfigError;
* ``tests/test_weighted_verbs.py``: weights on a 2-D mesh are a
  ConfigError;
* ``tests/test_faults.py``: the stalled butterfly stage on a (2, 1) mesh,
  quarantined under full verification and changing answers without it;
* ``core/bvss_delta.py``'s 2-D route: an edge update on a 2-D session
  rebuilds, with the reference's reason, and answers the updated graph.

Every rank's answers must equal rank 0's.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro
import torch_mesh as tm
from repro.core import reference_bfs as jbfs
from repro.graphs import from_edges as jfrom_edges
from repro.graphs import generators as jgen
from repro.graphs import src_of_edges
from repro.kernels.ref import (betweenness_ref, closeness_ref,
                               eccentricity_ref)
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks() -> list[dict]:
    """Every rank's results of :func:`torch_mesh.program_session_2d`."""
    return tm.run_ranks(tm.program_session_2d, 8)


@pytest.fixture(scope="module")
def single():
    jg = jgen.clustered(3, 23, seed=4)
    tm.same_graph(tm.clustered_graph(), jg)
    return jg, repro.GraphSession(jg, max_batch=3, w=256)


@pytest.mark.parametrize("shape", tm.SESSION_MESHES_2D,
                         ids=[f"{r}x{c}" for r, c in tm.SESSION_MESHES_2D])
def test_2d_session_transparency_and_sigma_parity(ranks, single, shape):
    jg, jsess = single
    got = tm.each_rank(ranks, ("session", shape), shape[0] * shape[1])
    q = tm.SESSION_QUERIES_2D
    for s, lv in zip(q, got["levels_batch"]):
        np.testing.assert_array_equal(lv, jbfs(jg, s), err_msg=f"src {s}")
    np.testing.assert_array_equal(got["levels"], jbfs(jg, q[2]))
    srcs = tm.BC_SOURCES_2D
    np.testing.assert_allclose(got["betweenness"], betweenness_ref(jg, srcs),
                               rtol=1e-6)
    np.testing.assert_allclose(got["betweenness"],
                               jsess.betweenness_batch(srcs), rtol=1e-6)
    np.testing.assert_array_equal(got["components"], jsess.components())
    np.testing.assert_array_equal(got["eccentricity"],
                                  eccentricity_ref(jg.symmetrized, q[:4]))
    np.testing.assert_allclose(got["closeness"], closeness_ref(jg, q[:4]),
                               rtol=1e-12)
    # the weighted verbs and the push direction: the reference refuses
    # them on a 2-D mesh, and so does the port
    assert got["sssp"].startswith("ConfigError") and "2-D" in got["sssp"]
    assert got["pagerank"].startswith("ConfigError") and \
        "2-D" in got["pagerank"]
    assert got["push"].startswith("ConfigError") and \
        "pull-only" in got["push"]


@pytest.mark.parametrize("shape", tm.SESSION_MESHES_2D,
                         ids=[f"{r}x{c}" for r, c in tm.SESSION_MESHES_2D])
def test_2d_session_update_rebuilds(ranks, shape):
    """An edge update on a 2-D session always rebuilds, with the
    reference's reason; the report equals the reference's single-device
    counts, and the new epoch's wave and single-source levels equal the
    oracle on the updated graph."""
    jg = jgen.clustered(3, 23, seed=4)
    jprep = repro.apply_edge_updates(
        repro.prepare(jg, options=repro.PrepareOptions(w=256)),
        inserts=tm.UPDATE_2D)
    got = tm.each_rank(ranks, ("update", shape), shape[0] * shape[1])
    rep = got["report"]
    assert rep["path"] == "rebuilt"
    assert rep["reason"] == \
        "2-D partition relabels columns; no local patch path"
    want = jprep.last_update
    for field in ("epoch", "n_inserted", "n_deleted", "n_reweighted",
                  "stale_edges"):
        assert rep[field] == getattr(want, field), field
    assert rep["sets_touched"] == jprep.bvss.n_sets
    assert rep["vss_rows_rewritten"] == jprep.bvss.num_vss
    g_now = jfrom_edges(jg.n, jprep.inv[src_of_edges(jprep.graph)],
                        jprep.inv[jprep.graph.indices], dedup=True,
                        drop_loops=False)
    q = tm.SESSION_QUERIES_2D
    for s, lv in zip(q, got["levels_batch"]):
        np.testing.assert_array_equal(lv, jbfs(g_now, s), err_msg=f"src {s}")
    np.testing.assert_array_equal(got["levels"], jbfs(g_now, q[2]))


def test_2d_mesh_weighted_session_is_typed_config_error(ranks):
    msg = tm.each_rank(ranks, "weighted_prepare", 4)
    assert msg.startswith("ConfigError") and "2-D" in msg


def test_stalled_butterfly_stage_caught_and_underdiscovers(ranks):
    """Stage 0's partner block dropped on every rank of a (2, 1) mesh:
    verified, every answer is the oracle's through one quarantine;
    unverified, the stall changes answers."""
    got = tm.each_rank(ranks, "stall_stage")
    jg = jgen.rmat(7, 8, seed=2)
    for s, lv in zip(tm.FAULT_QUERIES, got["verified"]):
        np.testing.assert_array_equal(lv, jbfs(jg, s))
    assert got["degraded"] >= 1
    assert got["stats"]["quarantines"] == 1
    assert sum(not np.array_equal(lv, jbfs(jg, s))
               for s, lv in zip(tm.FAULT_QUERIES, got["unverified"])) > 0


@pytest.mark.parametrize("direction", ["auto", "pull"])
@pytest.mark.parametrize("shape", tm.FUSED_SHAPES_2D,
                         ids=[f"{r}x{c}" for r, c in tm.FUSED_SHAPES_2D])
def test_fused_wave_marks_equal_seam_on_a_2d_mesh(ranks, shape, direction):
    """The 2-D wave engine with its marks fused into the bit-SpMM (partial
    hits OR-ed over the column axis) equals the same engine through the
    ``spmm_impl`` seam and the host BFS."""
    got = tm.each_rank(ranks, ("fused", shape), shape[0] * shape[1])
    tm.check_fused_and_seam(got[direction], tm.clustered_graph(),
                            tm.SESSION_QUERIES_2D, direction)
