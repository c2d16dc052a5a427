"""The 1-D mesh of the port (``repro_torch.distributed``, the sharded BVSS,
the sharded engines, ``prepare(g, mesh=)``, the launcher's ``--devices``)
against the JAX reference.

* The host partition (``build_sharded_bvss``, ``build_sharded_weight_plane``)
  and each rank's block (``shard_to_device``) equal the reference's arrays
  bit for bit, in process (the reference's masks are uint32, the port's
  device words int32: compared through a view).
* The mesh cases run once per module on one gloo group of 8 CPU ranks
  (``tests/torch_mesh.py``), on sub-meshes of the first P ranks, and
  mirror ``tests/test_distributed.py``: ``prepare(g, w=256, mesh=)`` on
  P in {1, 2, 8} for ``rmat(8, 8, seed=3)`` and ``grid2d(20, 16)``; the
  eager, lazy and BRS engines (kernels and twins, every direction) on
  P = 4; weights, autotune and the refusals.  Every rank's levels must
  equal the reference's single-device levels and ``reference_bfs``, bit
  for bit.  One level's ledger bytes equal what the reference's
  ``frontier_all_gather`` records for one traced level.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
import torch_mesh as tm
from repro.core import bvss as jbvss
from repro.distributed.bfs_dist import frontier_all_gather as j_gather
from repro.distributed.collectives import comm_ledger as j_ledger
from repro.graphs import generators as jgen
from repro_torch.core import bvss as tbvss
from repro_torch.distributed import bfs_mesh
from repro_torch.errors import ConfigError
from repro_torch.launch import bfs as tlaunch
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
J_GRAPHS = {"rmat": jgen.rmat(8, 8, seed=3), "grid": jgen.grid2d(20, 16)}
J_ENGINE_GRAPH = jgen.rmat(8, 8, seed=5)


@pytest.fixture(scope="module")
def ranks() -> list[dict]:
    """Every rank's results of :func:`torch_mesh.program_1d`."""
    return tm.run_ranks(tm.program_1d, 8)


_JAX_PREPARED: dict = {}


def jax_levels(g, src: int, **options) -> np.ndarray:
    """The reference's single-device levels of ``prepare(g, w=256)``
    (one preparation per graph and options for the module)."""
    key = (id(g), tuple(sorted(options.items())))
    if key not in _JAX_PREPARED:
        _JAX_PREPARED[key] = repro.prepare(
            g, options=repro.PrepareOptions(w=256, **options))
    return np.asarray(_JAX_PREPARED[key].levels(src))


# ---------------------------------------------------------------------------
# host partition, in process
# ---------------------------------------------------------------------------
def same_graph(name: str):
    tg = {**tm.sweep_graphs(), "engine": tm.engine_graph()}[name]
    jg = {**J_GRAPHS, "engine": J_ENGINE_GRAPH}[name]
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    return tg, jg


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("name", ["rmat", "grid", "engine"])
def test_sharded_partition_equals_reference(name, D):
    tg, jg = same_graph(name)
    t = tbvss.build_sharded_bvss(tg, D)
    j = jbvss.build_sharded_bvss(jg, D)
    for field in ("n", "m", "sigma", "n_shards", "rows_per_shard",
                  "num_vss_pad", "n_sets", "max_vss_per_set",
                  "n_frontier_words"):
        assert getattr(t, field) == getattr(j, field), field
    for field in ("masks", "row_ids", "virtual_to_real", "vss_start",
                  "vss_end"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_sharded_weight_plane_equals_reference(D):
    tg, jg = same_graph("engine")
    w = tm.weights_of(tg)
    t = tbvss.build_sharded_weight_plane(tg, w, tbvss.build_sharded_bvss(
        tg, D))
    j = jbvss.build_sharded_weight_plane(jg, w, jbvss.build_sharded_bvss(
        jg, D))
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("D", [1, 2, 8])
def test_shard_to_device_equals_reference_blocks(D):
    """Each rank's block is the reference's stacked device arrays' shard,
    dummy VSS included."""
    tg, jg = same_graph("rmat")
    tsb = tbvss.build_sharded_bvss(tg, D)
    jdev = jbvss.shard_to_device(jbvss.build_sharded_bvss(jg, D))
    for d in range(D):
        blk = tbvss.shard_to_device(tsb, shard=d, device="cpu")
        np.testing.assert_array_equal(
            blk.masks.numpy().view(np.uint32), np.asarray(jdev.masks[d]))
        for field in ("row_ids", "virtual_to_real", "vss_of_vertex_start",
                      "vss_of_vertex_end"):
            np.testing.assert_array_equal(
                getattr(blk, field).numpy(),
                np.asarray(getattr(jdev, field)[d]), err_msg=field)


def test_shard_to_device_needs_a_mesh_or_a_shard():
    tg, _ = same_graph("rmat")
    with pytest.raises(ConfigError, match="mesh or a shard"):
        tbvss.shard_to_device(tbvss.build_sharded_bvss(tg, 2), device="cpu")


# ---------------------------------------------------------------------------
# the mesh cases: one gloo group of 8 ranks for the module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", tm.SWEEP_RANKS)
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_sharded_prepare_matches_oracle(ranks, name, P):
    """``prepare(g, w=256, mesh=)`` on every mesh size: every rank answers
    the whole graph, equal to the reference's single-device levels and the
    host oracle."""
    jg = J_GRAPHS[name]
    srcs = tm.sources_of(jg)
    want = [jax_levels(jg, s) for s in srcs]
    for rank in range(P):
        got = ranks[rank][("sweep", P, name)]
        assert got["engine"] == _JAX_PREPARED[(id(jg), ())].engine_name
        for s, lv, ref in zip(srcs, got["levels"], want):
            np.testing.assert_array_equal(lv, ref, err_msg=f"{rank} {s}")
            np.testing.assert_array_equal(
                lv, repro_torch.reference_bfs(tm.sweep_graphs()[name], s))


@pytest.mark.parametrize("P", tm.SWEEP_RANKS)
@pytest.mark.parametrize("eng", tm.BVSS_ENGINES)
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_sharded_engines_on_every_mesh_size(ranks, name, eng, P):
    """The eager, lazy and BRS engines on 1, 2 and 8 ranks (4: the
    variants below): every rank's levels equal the reference's
    single-device engine's and the host oracle."""
    jg = J_GRAPHS[name]
    for i, s in enumerate(tm.sources_of(jg)):
        want = jax_levels(jg, s, engine=eng)
        np.testing.assert_array_equal(
            want, repro_torch.reference_bfs(tm.sweep_graphs()[name], s))
        for rank in range(P):
            np.testing.assert_array_equal(
                ranks[rank][("sweep_engine", P, name, eng)][i], want,
                err_msg=f"rank {rank} source {s}")


ENGINE_CASES = [(e, k, d) for e in ("blest", "blest_lazy", "brs")
                for k in (True, False)
                for d in (("auto",) if e == "brs" else
                          ("auto", "pull", "push"))]


@pytest.mark.parametrize("eng,use_kernels,direction", ENGINE_CASES)
def test_sharded_engine_variants_match_oracle(ranks, eng, use_kernels,
                                              direction):
    """Every BVSS engine through the sharded pipeline on 4 ranks; the
    kernel/twin switch and the direction must not change levels."""
    jg = J_ENGINE_GRAPH
    tg = tm.engine_graph()
    for i, s in enumerate((0, jg.n - 1)):
        want = jax_levels(jg, s, engine=eng)
        np.testing.assert_array_equal(want, repro_torch.reference_bfs(tg, s))
        for rank in range(tm.ENGINE_RANKS):
            got = ranks[rank][("engine", eng, use_kernels, direction)][i]
            np.testing.assert_array_equal(got, want, err_msg=f"{rank} {s}")


def test_sharded_autotune_matches_oracle(ranks):
    """``autotune=True`` under a mesh tunes, as the reference does, and
    answers the same levels."""
    tg = tm.engine_graph()
    for rank in range(tm.ENGINE_RANKS):
        got = ranks[rank]["autotune"]
        assert got["tile_config"]
        for s, lv in zip((0, tg.n - 1), got["levels"]):
            np.testing.assert_array_equal(lv,
                                          repro_torch.reference_bfs(tg, s))


def test_sharded_weight_plane_on_ranks(ranks):
    """``prepare(weights=, mesh=)`` on a 1-D mesh: each rank keeps its own
    block of the reference's sharded weight plane, +inf row appended."""
    jg = J_ENGINE_GRAPH
    w = tm.weights_of(jg)
    j = jbvss.build_sharded_weight_plane(
        jg, w, jbvss.build_sharded_bvss(jg, tm.WEIGHT_RANKS))
    full = np.asarray(jbvss.weight_plane_to_device(j))
    for rank in range(tm.WEIGHT_RANKS):
        np.testing.assert_array_equal(ranks[rank]["wplane"], full[rank])
        np.testing.assert_array_equal(
            ranks[rank]["wplane_levels"],
            repro_torch.reference_bfs(tm.engine_graph(), 0))


@pytest.mark.parametrize("P", tm.SWEEP_RANKS)
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_one_level_ledger_equals_reference(ranks, name, P):
    """The port records once per executed call; one level's bytes equal
    what the reference's ``frontier_all_gather`` records tracing one
    level's gather of the same words on a P-device axis."""
    for rank in range(P):
        got = ranks[rank][("ledger", P, name)]
        with j_ledger() as want:
            jax.make_jaxpr(lambda fw: j_gather(fw, "data"),
                           axis_env=[("data", P)])(
                jnp.zeros((got["lwords"],), jnp.uint32))
        assert got["events"] == want, (rank, got, want)


@pytest.mark.parametrize("eng,start", [("blest", 1), ("blest_lazy", 1),
                                       ("brs", 0)])
def test_sharded_level_makes_one_host_copy(ranks, eng, start):
    """A sharded level reads one value to the host: the level's scalars
    and the all-reduced continuation test ride in one copy (BLEST also
    reads once at the start)."""
    for rank in range(tm.WEIGHT_RANKS):
        got = ranks[rank][("host_reads", eng)]
        assert got["levels"] > 3, got
        assert got["reads"] == got["levels"] + start, (rank, got)


def test_sharded_prepare_rejects_non_bvss_engines(ranks):
    msg = ranks[0]["non_bvss"]
    assert msg is not None and msg.startswith("ValueError")
    assert "mesh-native" in msg


def test_mesh_device_type_must_match_options(ranks):
    """A gloo (CPU) mesh under the default device (the card) is a
    ConfigError: the port never quietly moves a mesh to the CPU."""
    msg = ranks[0]["device_mismatch"]
    assert msg is not None and msg.startswith("ConfigError")


def test_mesh_axis_must_name_a_dimension(ranks):
    msg = ranks[0]["bad_axis"]
    assert msg is not None and msg.startswith("ConfigError")
    assert "'rows'" in msg


def test_mesh_over_request_raises_config_error(ranks):
    """More ranks than the group holds, CUDA ranks past the cards, or no
    process group at all: ConfigError (a ValueError) at the builder."""
    assert ranks[0]["over_request"].startswith("ConfigError: requested 9")
    assert ranks[0]["cuda_over_request"].startswith("ConfigError")
    assert "CUDA" in ranks[0]["cuda_over_request"]
    with pytest.raises(ConfigError, match="process group"):
        bfs_mesh(2, device_type="cpu")
    with pytest.raises(ValueError):
        bfs_mesh(2, device_type="cpu")


def test_unported_mesh_paths_name_their_slice(ranks):
    got = ranks[0]
    assert got["update_edges"].startswith("ConfigError")
    assert "item 11e" in got["update_edges"]
    for key in ("multi_source", "session"):
        assert got[key].startswith("ConfigError") and "item 11c" in got[key]


# ---------------------------------------------------------------------------
# the launcher's --devices
# ---------------------------------------------------------------------------
def test_launcher_devices_verifies_on_cpu():
    """``--devices 2 --device cpu`` spawns two gloo ranks; rank 0 prints
    the sharded line and the verdict, once."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bfs", "--graph", "road",
         "--scale", "8", "--engine", "blest_ac", "--sources", "2",
         "--devices", "2", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].endswith("device=cpu mesh=2x1"), lines[0]
    assert lines[1].startswith("[bfs] sharded: 2 shards x 128 rows"), lines
    assert len(lines) == 4, lines
    assert lines[-1].startswith("[bfs] blest_ac: ")
    assert lines[-1].endswith("VERIFIED vs oracle"), lines[-1]


@pytest.mark.parametrize("flags,match", [
    (["--devices", "99"], "CUDA cards"),
    (["--devices", "0", "--device", "cpu"], "at least one rank"),
    (["--devices", "2", "--device", "cpu", "--engine", "csr_push"],
     "BVSS engine"),
], ids=["cards", "zero", "csr"])
def test_launcher_devices_refusals(flags, match):
    """Checked before any process starts.  Without ``--device cpu`` the
    ranks are CUDA ranks, one a card."""
    with pytest.raises(ConfigError, match=match):
        tlaunch.main(["--graph", "road", "--scale", "6", *flags])
