"""The 2-D (row × column) mesh of the port and its butterfly collectives
against the JAX reference, mirroring ``tests/test_distributed_2d.py`` and
``tests/test_policy_2d.py``.

* ``build_sharded_bvss_2d`` equals the reference's arrays bit for bit, in
  process; so do the ledger's semantics (``record_comm``/``comm_ledger``).
* The mesh cases run once per module on one gloo group of 8 CPU ranks
  (``tests/torch_mesh.py``): the butterfly exchange and OR all-reduce
  against the flat all-gather on 2, 4 and 8 ranks and the fallback on 3;
  ``clustered(3, 23, seed=4)`` on meshes (1, 1), (2, 1), (2, 2) and
  (4, 2), eager and lazy; the isolated sources and the 70-vertex path;
  forced push, BRS and weights refused.  Levels equal the reference's
  single-device levels and ``reference_bfs`` bit for bit, and one level's
  ledger bytes equal what the reference's collectives record tracing one
  level's exchange.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
import torch_mesh as tm
from repro.core import bvss as jbvss
from repro.distributed import collectives as jcoll
from repro.graphs import generators as jgen
from repro_torch.core import bvss as tbvss
from repro_torch.distributed import bfs_mesh2d, comm_ledger, record_comm
from repro_torch.errors import ConfigError
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks() -> list[dict]:
    """Every rank's results of :func:`torch_mesh.program_2d`."""
    return tm.run_ranks(tm.program_2d, 8)


def traced(fn, shape, axes: list[tuple[str, int]]) -> list:
    """What the reference's ledger records tracing ``fn`` over uint32
    words of ``shape`` with the named ``axes``."""
    with jcoll.comm_ledger() as events:
        jax.make_jaxpr(fn, axis_env=axes)(jnp.zeros(shape, jnp.uint32))
    return events


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 2), (3, 3)])
@pytest.mark.parametrize("name", ["clustered", "rmat"])
def test_sharded_bvss_2d_equals_reference(name, shape):
    tg = {"clustered": tm.clustered_graph(),
          "rmat": repro_torch.generators.rmat(7, 8, seed=2)}[name]
    jg = {"clustered": jgen.clustered(3, 23, seed=4),
          "rmat": jgen.rmat(7, 8, seed=2)}[name]
    t = tbvss.build_sharded_bvss(tg, shape)
    j = jbvss.build_sharded_bvss(jg, shape)
    for field in ("n", "m", "sigma", "rows", "cols", "rows_per_shard",
                  "cols_per_block", "num_vss_pad", "n_sets_local",
                  "max_vss_per_set", "n_blocks", "n_frontier_words_local",
                  "words_per_colseg"):
        assert getattr(t, field) == getattr(j, field), field
    for field in ("masks", "row_ids", "virtual_to_real"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    jdev = jbvss.shard_to_device_2d(j)
    for d in range(t.n_blocks):
        blk = tbvss.shard_to_device_2d(t, shard=d, device="cpu")
        np.testing.assert_array_equal(blk.masks.numpy().view(np.uint32),
                                      np.asarray(jdev.masks[d]))
        for field in ("row_ids", "virtual_to_real", "vss_of_vertex_start",
                      "vss_of_vertex_end"):
            np.testing.assert_array_equal(
                getattr(blk, field).numpy(),
                np.asarray(getattr(jdev, field)[d]), err_msg=field)


@pytest.mark.parametrize("shape,match", [
    ((0, 1), "positive"), ((2, -1), "positive"), ((1, 2), "rows >= cols")])
def test_sharded_bvss_2d_shape_validation(shape, match):
    with pytest.raises(ConfigError, match=match):
        tbvss.build_sharded_bvss_2d(tm.clustered_graph(), *shape)


def test_comm_ledger_unit():
    """Ledger semantics: records only while open, nested ledgers shadow,
    bytes sum exactly."""
    record_comm("dropped", 999)        # no open ledger: silently ignored
    with comm_ledger() as outer:
        record_comm("a", 100)
        with comm_ledger() as inner:
            record_comm("b", 50)
        record_comm("c", 7)
    assert inner == [("b", 50)]
    assert outer == [("a", 100), ("c", 7)]
    assert sum(n for _, n in outer) == 107


def test_mesh2d_shape_validation():
    with pytest.raises(ConfigError, match="positive"):
        bfs_mesh2d(0, 1, device_type="cpu")
    with pytest.raises(ConfigError, match="positive"):
        bfs_mesh2d(2, -1, device_type="cpu")
    # rows < cols leaves column shards without a full row block
    with pytest.raises(ConfigError, match="rows >= cols"):
        bfs_mesh2d(1, 2, device_type="cpu")
    # the shape is checked first; then the group: none here
    with pytest.raises(ConfigError, match="process group"):
        bfs_mesh2d(2, 2, device_type="cpu")


# ---------------------------------------------------------------------------
# the mesh cases: one gloo group of 8 ranks for the module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4, 8])
def test_butterfly_collectives_match_flat(ranks, n):
    """On power-of-two axes the staged butterfly exchange reproduces the
    index-ordered all-gather exactly, and the OR all-reduce the gather+OR;
    the stall seam visibly zeroes the partner block."""
    words = tm.butterfly_words(n)
    ref_or = np.bitwise_or.reduce(words.reshape(n, -1, 3), axis=0)
    for rank in range(n):
        got = ranks[rank][("butterfly", n)]
        np.testing.assert_array_equal(got["flat"], words)
        np.testing.assert_array_equal(got["exchange"], words)
        np.testing.assert_array_equal(got["or"], ref_or)
        assert (got["stalled"] != words).any(), rank


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_butterfly_ledger_equals_reference(ranks, n):
    """Every stage records what the reference records tracing the same
    collective over the same block on an n-device axis; on 3 ranks both
    record the flat fallback."""
    words = tm.butterfly_words(n)
    block = (words.shape[0] // n,) + words.shape[1:]
    want_bf = traced(lambda w: jcoll.butterfly_frontier_exchange(w, "x"),
                     block, [("x", n)])
    want_or = traced(lambda w: jcoll.butterfly_or_allreduce(w, "x"),
                     block, [("x", n)])
    if n == 3:
        assert [lab for lab, _ in want_bf + want_or] == \
            ["butterfly_fallback_flat", "or_allreduce_fallback_flat"]
    for rank in range(n):
        got = ranks[rank][("butterfly", n)]
        assert got["ledger_exchange"] == want_bf, (rank, got, want_bf)
        assert got["ledger_or"] == want_or, (rank, got, want_or)


@pytest.mark.parametrize("shape", tm.MESHES_2D)
@pytest.mark.parametrize("eng", ["blest", "blest_lazy"])
def test_2d_prepare_matches_oracle_across_meshes(ranks, shape, eng):
    """A ragged clustered graph (n = 69) through eager and lazy engines on
    every mesh: bit for bit the reference's single-device levels and the
    host oracle, on every rank."""
    jg = jgen.clustered(3, 23, seed=4)
    srcs = tm.sources_of(jg)
    jp = repro.prepare(jg, options=repro.PrepareOptions(w=256, engine=eng))
    for i, s in enumerate(srcs):
        want = np.asarray(jp.levels(s))
        np.testing.assert_array_equal(
            want, repro_torch.reference_bfs(tm.clustered_graph(), s))
        for rank in range(shape[0] * shape[1]):
            np.testing.assert_array_equal(
                ranks[rank][("clustered", shape, eng)][i], want,
                err_msg=f"{shape} rank {rank} source {s}")


@pytest.mark.parametrize("shape", tm.MESHES_2D)
def test_one_level_ledger_equals_reference(ranks, shape):
    """One level of the 2-D engine records the reference's traced level:
    the OR all-reduce of ``lwords`` words over the column axis, then the
    segment exchange of ``wpc`` words over the row axis."""
    rows, cols = shape
    axes = [("data", rows), ("col", cols)]
    for rank in range(rows * cols):
        got = ranks[rank][("ledger", shape)]
        want = traced(lambda w: jcoll.butterfly_or_allreduce(w, "col"),
                      (got["lwords"],), axes) + \
            traced(lambda w: jcoll.butterfly_frontier_exchange(w, "data"),
                   (got["wpc"],), axes)
        assert got["events"] == want, (shape, rank, got, want)


def test_2d_isolated_sources_and_empty_columns(ranks):
    """Isolated vertices (instant termination), and a path whose frontier
    occupies a single column block for entire levels: empty column
    segments stay inert on both mesh shapes."""
    gi = tm.isolated_graph()
    for rank in range(4):
        for s, lv in zip((0, 1, 10, 49), ranks[rank]["isolated"]):
            np.testing.assert_array_equal(lv,
                                          repro_torch.reference_bfs(gi, s))
    gp = tm.path_graph()
    for shape in ((2, 2), (4, 2)):
        for rank in range(shape[0] * shape[1]):
            for s, lv in zip((0, gp.n - 1, gp.n // 2),
                             ranks[rank][("path", shape)]):
                np.testing.assert_array_equal(
                    lv, repro_torch.reference_bfs(gp, s),
                    err_msg=f"{shape} rank {rank} source {s}")


def test_2d_forced_push_rejected(ranks):
    """The 2-D engines are pull-only: forced push is a typed refusal; auto
    quietly pulls and answers correctly."""
    msg = ranks[0]["push"]
    assert msg.startswith("ConfigError") and "pull" in msg.lower()
    for rank in range(4):
        np.testing.assert_array_equal(
            ranks[rank]["auto"],
            repro_torch.reference_bfs(tm.clustered_graph(), 0))


@pytest.mark.parametrize("key,match", [("brs", "2-D partition"),
                                       ("weights", "edge weights")])
def test_2d_brs_and_weights_rejected(ranks, key, match):
    msg = ranks[0][key]
    assert msg.startswith("ConfigError") and match in msg, msg


def test_2d_mesh_over_request_raises_config_error(ranks):
    assert ranks[0]["over_request"].startswith("ConfigError: requested 12")


def test_bench_dist_2d_block_equals_reference(ranks):
    """``benchmarks/bench_dist.py``'s ``run_2d`` block on the 8 ranks at
    the reference's scale 9: the 2-D engines verified, and one level's
    per-rank bytes (butterfly on 2 x 2 and 4 x 2, flat on 4 and 8 ranks)
    equal to the reference's in ``BENCH_pr10.json``, keys included."""
    got = ranks[0]["bench_dist_2d"]
    ref = json.loads((Path(__file__).resolve().parents[1]
                      / "BENCH_pr10.json").read_text())["dist"]["dist2d"]
    assert got["verified"] and got["scale"] == ref["scale"] == 9
    assert got.keys() == ref.keys()
    assert got["comm"] == ref["comm"]
    for name, row in ref["meshes"].items():
        assert got["meshes"][name].keys() == row.keys()
        for field in ("devices", "rows_per_shard", "cols_per_block",
                      "frontier_words_local", "comm_bytes_per_level",
                      "verified"):
            assert got["meshes"][name][field] == row[field], (name, field)
