"""Incremental BVSS maintenance of the port (``repro_torch.core.bvss_delta``)
against the JAX package's (``repro.core.bvss_delta``), on the CPU.

Every case of ``tests/test_bvss_delta.py`` but the mesh one runs here on the
same numpy-seeded graph through both packages (the reference with
``use_kernels=False``, the port with ``device="cpu"``), the same update
batches applied to each.  After every update the port's host ``masks`` and
``row_ids``, its device ``masks`` and ``row_ids``, its weight plane, its
``UpdateReport`` (``reason`` string included) and its levels equal the
reference's bit for bit, and both equal a fresh ``build_bvss`` of the
mutated graph.  One case is the port's own: a patch builds new device
tensors and never writes the old epoch's.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro_torch
from repro.graphs import generators as jgen
from repro_torch import (GraphValidationError, StaleEpochError,
                         apply_edge_updates, from_edges)
from repro_torch.core import build_bvss, reference_bfs
from repro_torch.core.bvss_delta import STALENESS_FRACTION
from repro_torch.errors import ConfigError
from repro_torch.graphs import generators as gen, src_of_edges
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def graphs():
    return jgen.rmat(7, 8, seed=21), gen.rmat(7, 8, seed=21)


@pytest.fixture(scope="module")
def graph(graphs):
    return graphs[1]


def _prep(g, **opts):
    return repro_torch.prepare(g, options=repro_torch.PrepareOptions(
        w=512, seed=0, device="cpu", **opts))


class Pair:
    """A reference and a port preparation of the same graph, updated call
    for call and held equal after each update."""

    def __init__(self, graphs, **opts):
        jg, tg = graphs
        self.j = repro.prepare(jg, options=repro.PrepareOptions(
            w=512, seed=0, use_kernels=False, **opts))
        self.t = _prep(tg, **opts)
        self.assert_equal()

    def update(self, **kw):
        j2 = repro.apply_edge_updates(self.j, **kw)
        t2 = apply_edge_updates(self.t, **kw)
        assert (j2 is self.j) == (t2 is self.t)
        self.j, self.t = j2, t2
        self.assert_equal()
        return t2

    def assert_equal(self, sources=(0, 64)):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.perm, j.perm)
        np.testing.assert_array_equal(t.graph.indptr, j.graph.indptr)
        np.testing.assert_array_equal(t.graph.indices, j.graph.indices)
        for f in ("masks", "row_ids", "real_ptrs", "virtual_to_real"):
            np.testing.assert_array_equal(getattr(t.bvss, f),
                                          getattr(j.bvss, f), err_msg=f)
        assert (t.bvss.num_slices, t.bvss.m) == (j.bvss.num_slices,
                                                 j.bvss.m)
        assert (t.problem is None) == (j.problem is None)
        if t.problem is not None:
            np.testing.assert_array_equal(
                t.problem.dev.masks.numpy().view(np.uint32),
                np.asarray(j.problem.dev.masks))
            np.testing.assert_array_equal(t.problem.dev.row_ids.numpy(),
                                          np.asarray(j.problem.dev.row_ids))
            assert t.problem.num_vss == j.problem.num_vss
        assert (t.wplane is None) == (j.wplane is None)
        if t.wplane is not None:
            np.testing.assert_array_equal(t.wplane.numpy(),
                                          np.asarray(j.wplane))
            np.testing.assert_array_equal(t.weights, j.weights)
        assert (t.epoch, t.stale_edges) == (j.epoch, j.stale_edges)
        assert (t.last_update is None) == (j.last_update is None)
        if t.last_update is not None:
            assert dataclasses.asdict(t.last_update) == \
                dataclasses.asdict(j.last_update)
        for s in sources:
            np.testing.assert_array_equal(t.levels(s), j.levels(s))
        _assert_fresh_build_parity(t)


def _caller_graph(prep):
    """The caller-id view of the prepared (ordered) graph."""
    src_c = prep.inv[src_of_edges(prep.graph)]
    dst_c = prep.inv[prep.graph.indices]
    return from_edges(prep.graph.n, src_c, dst_c, dedup=True,
                      drop_loops=False)


def _missing_edge(prep):
    """Some (a, b) caller-id pair that is NOT an edge of prep.graph."""
    have = set(zip(prep.inv[src_of_edges(prep.graph)].tolist(),
                   prep.inv[prep.graph.indices].tolist()))
    n = prep.graph.n
    return next((a, b) for a in range(n) for b in range(n)
                if a != b and (a, b) not in have)


def _growing_inserts(prep):
    """Caller-id edges, all from one source, that fill its slice set's last
    VSS and add one row more (from a set with no slices, one edge), so the
    set's VSS count grows."""
    b = prep.bvss
    rows_of = {}
    srcs, dsts = b.reconstruct_edges()
    for s, d in zip(srcs // b.sigma, dsts):
        rows_of.setdefault(int(s), set()).add(int(d))
    room = {I: int(b.real_ptrs[I + 1] - b.real_ptrs[I]) * b.tau
            - len(rows_of.get(I, ())) for I in range(b.n_sets)}
    for I in sorted(room, key=room.get):
        s = I * b.sigma
        new = [d for d in range(b.n)
               if d != s and d not in rows_of.get(I, ())][:room[I] + 1]
        if s < b.n and len(new) == room[I] + 1:
            return [(int(prep.inv[s]), int(prep.inv[d])) for d in new]
    raise AssertionError("no slice set can grow by one VSS")


def _assert_fresh_build_parity(prep):
    """prep's BVSS must equal a fresh build of prep.graph bit for bit."""
    b2 = build_bvss(prep.graph, sigma=prep.bvss.sigma)
    np.testing.assert_array_equal(prep.bvss.masks, b2.masks)
    np.testing.assert_array_equal(prep.bvss.row_ids, b2.row_ids)
    np.testing.assert_array_equal(prep.bvss.real_ptrs, b2.real_ptrs)
    np.testing.assert_array_equal(prep.bvss.virtual_to_real,
                                  b2.virtual_to_real)
    assert prep.bvss.num_slices == b2.num_slices
    assert prep.bvss.m == b2.m


# ---------------------------------------------------------------------------
# bit-identity on randomized insert/delete sequences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_sequences_bit_identical(graphs, seed):
    pair = Pair(graphs)
    graph = graphs[1]
    rng = np.random.default_rng(seed)
    for round_i in range(4):
        prep = pair.t
        ins = sorted({(int(a), int(b))
                      for a, b in rng.integers(0, graph.n, (5, 2))
                      if a != b})
        src_c = prep.inv[src_of_edges(prep.graph)]
        dst_c = prep.inv[prep.graph.indices]
        pick = rng.choice(len(src_c), size=3, replace=False)
        dels = sorted({(int(src_c[p]), int(dst_c[p])) for p in pick}
                      - set(ins))
        prep = pair.update(inserts=ins, deletes=dels)
        assert prep.epoch == round_i + 1
        assert prep.last_update.path in ("patched", "rebuilt",
                                         "reprepared")
        g_now = _caller_graph(prep)
        for s in (0, graph.n // 2):
            np.testing.assert_array_equal(prep.levels(s),
                                          reference_bfs(g_now, s))


@pytest.mark.parametrize("sigma", [8, 32])
def test_every_path_matches_reference(graphs, sigma):
    """A patch, a rebuild (an insert that grows its set's VSS count) and a
    re-prepare, in that order, each equal to the reference's."""
    pair = Pair(graphs, sigma=sigma)
    assert pair.update(inserts=[_missing_edge(pair.t)]).last_update.path \
        == "patched"
    rep = pair.update(inserts=_growing_inserts(pair.t)).last_update
    assert rep.path == "rebuilt" and "VSSs" in rep.reason
    rep = pair.update(inserts=[_missing_edge(pair.t)],
                      staleness_budget=1).last_update
    assert rep.path == "reprepared"


def test_insert_makes_vertex_reachable(graphs):
    pair = Pair(graphs)
    lv0 = pair.t.levels(0)
    far = int(np.argmax(lv0 == INF))
    assert lv0[far] == INF
    prep2 = pair.update(inserts=[(0, far)])
    assert prep2.levels(0)[far] == 1


def test_delete_disconnects(graphs):
    pair = Pair(graphs)
    prep = pair.t
    # pick a real edge and delete it; the edge count drops by one
    a = int(src_of_edges(prep.graph)[0])
    b = int(prep.graph.indices[0])
    edge = (int(prep.inv[a]), int(prep.inv[b]))
    prep2 = pair.update(deletes=[edge])
    assert prep2.graph.m == prep.graph.m - 1
    _assert_fresh_build_parity(prep2)


# ---------------------------------------------------------------------------
# epoch versioning
# ---------------------------------------------------------------------------
def test_epoch_advances_and_old_arrays_untouched(graphs):
    """Functional updates: epoch N's device masks are NOT mutated by the
    epoch N+1 patch — an in-flight wave holding the old problem keeps a
    consistent structure."""
    pair = Pair(graphs)
    prep = pair.t
    assert prep.epoch == 0
    old_masks = prep.problem.dev.masks.clone()
    old_host_masks = prep.bvss.masks.copy()
    prep2 = pair.update(inserts=[_missing_edge(prep)])
    assert prep2.epoch == 1 and prep.epoch == 0
    np.testing.assert_array_equal(prep.bvss.masks, old_host_masks)
    assert bool((prep.problem.dev.masks == old_masks).all())
    # the old prepared still answers on the OLD graph
    np.testing.assert_array_equal(prep.levels(0),
                                  reference_bfs(_caller_graph(prep), 0))


def test_patch_builds_new_device_tensors(graphs):
    """The port's own isolation: torch tensors are mutable, so a patch
    writes the touched rows into clones.  The old epoch's masks, row ids
    and weight plane are other tensors than the new epoch's and keep
    their contents; the fields a patch cannot change are shared."""
    jg, tg = graphs
    rng = np.random.default_rng(7)
    w = (rng.integers(1, 128, tg.m) / 32.0).astype(np.float32)
    prep = _prep(tg, weights=w)
    dev = prep.problem.dev
    before = {f: getattr(dev, f).clone() for f in dev._fields}
    plane = prep.wplane.clone()
    e0 = (int(prep.inv[src_of_edges(prep.graph)[0]]),
          int(prep.inv[prep.graph.indices[0]]))
    prep2 = apply_edge_updates(prep, inserts=[_missing_edge(prep), e0],
                               insert_weights=[2.5, 9.0])
    assert prep2.last_update.path == "patched"
    assert prep2.last_update.n_reweighted == 1
    dev2 = prep2.problem.dev
    for f in ("masks", "row_ids"):
        assert getattr(dev2, f).data_ptr() != getattr(dev, f).data_ptr()
        assert not torch_equal(getattr(dev2, f), getattr(dev, f)), f
    assert prep2.wplane.data_ptr() != prep.wplane.data_ptr()
    for f in ("virtual_to_real", "real_ptrs", "vss_of_vertex_start",
              "vss_of_vertex_end"):
        assert getattr(dev2, f) is getattr(dev, f), f
    for f in dev._fields:
        assert torch_equal(getattr(dev, f), before[f]), f
    assert torch_equal(prep.wplane, plane)
    np.testing.assert_array_equal(prep.levels(0),
                                  reference_bfs(_caller_graph(prep), 0))
    np.testing.assert_array_equal(prep2.levels(0),
                                  reference_bfs(_caller_graph(prep2), 0))


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def test_expected_epoch_cas(graphs):
    pair = Pair(graphs)
    prep = pair.t
    new = _missing_edge(prep)
    prep2 = pair.update(inserts=[new], expected_epoch=0)
    assert prep2.epoch == 1
    with pytest.raises(StaleEpochError) as ei:
        apply_edge_updates(prep, inserts=[_missing_edge(prep)],
                           expected_epoch=1)
    assert ei.value.expected == 1 and ei.value.actual == 0
    with pytest.raises(repro.StaleEpochError):
        repro.apply_edge_updates(pair.j, inserts=[new], expected_epoch=0)


def test_noop_update_returns_same_object(graphs):
    pair = Pair(graphs)
    prep = pair.t
    # inserting an existing edge of an unweighted prepared is a no-op
    a = int(prep.inv[src_of_edges(prep.graph)[0]])
    b = int(prep.inv[prep.graph.indices[0]])
    assert pair.update(inserts=[(a, b)]) is prep
    assert apply_edge_updates(prep) is prep
    assert repro.apply_edge_updates(pair.j) is pair.j


# ---------------------------------------------------------------------------
# staleness ledger -> full re-prepare
# ---------------------------------------------------------------------------
def test_staleness_budget_forces_reprepare(graphs):
    pair = Pair(graphs)
    prep2 = pair.update(inserts=[_missing_edge(pair.t)], staleness_budget=0)
    assert prep2.last_update.path == "reprepared"
    assert prep2.stale_edges == 0
    assert "staleness" in prep2.last_update.reason
    _assert_fresh_build_parity(prep2)
    np.testing.assert_array_equal(
        prep2.levels(0), reference_bfs(_caller_graph(prep2), 0))


def test_stale_ledger_accumulates_until_budget(graphs):
    pair = Pair(graphs)
    graph = graphs[1]
    budget = max(1, int(STALENESS_FRACTION * graph.m))
    rng = np.random.default_rng(3)
    while pair.t.last_update is None or \
            pair.t.last_update.path != "reprepared":
        ins = sorted({(int(a), int(b))
                      for a, b in rng.integers(0, graph.n, (8, 2))
                      if a != b})
        pair.update(inserts=ins)
        assert pair.t.epoch <= 4 * budget, "re-prepare never triggered"
    assert pair.t.stale_edges == 0         # ledger reset by the re-prepare


# ---------------------------------------------------------------------------
# weighted plane
# ---------------------------------------------------------------------------
def test_weighted_insert_and_reweight(graphs):
    graph = graphs[1]
    rng = np.random.default_rng(4)
    w = (rng.integers(1, 128, graph.m) / 32.0).astype(np.float32)
    pair = Pair(graphs, weights=w)
    prep = pair.t
    assert prep.weights is not None

    lv0 = prep.levels(0)
    far = int(np.argmax(lv0 == INF))
    prep2 = pair.update(inserts=[(0, far)], insert_weights=[2.5])
    # the merged weight vector holds the new edge's weight at its slot
    a_ord, b_ord = int(prep2.perm[0]), int(prep2.perm[far])
    keys = (src_of_edges(prep2.graph).astype(np.int64) * prep2.graph.n
            + prep2.graph.indices)
    slot = int(np.searchsorted(keys, a_ord * prep2.graph.n + b_ord))
    assert prep2.weights[slot] == np.float32(2.5)

    # re-inserting an existing edge with a new weight is a reweight
    e0 = (int(prep2.inv[src_of_edges(prep2.graph)[0]]),
          int(prep2.inv[prep2.graph.indices[0]]))
    prep3 = pair.update(inserts=[e0], insert_weights=[9.0])
    assert prep3.last_update.n_reweighted == 1
    keys3 = (src_of_edges(prep3.graph).astype(np.int64) * prep3.graph.n
             + prep3.graph.indices)
    slot3 = int(np.searchsorted(
        keys3, int(prep3.perm[e0[0]]) * prep3.graph.n
        + int(prep3.perm[e0[1]])))
    assert prep3.weights[slot3] == np.float32(9.0)
    # and a weighted re-prepare carries the weights through the ordering
    prep4 = pair.update(inserts=[_missing_edge(prep3)],
                        insert_weights=[0.25], staleness_budget=0)
    assert prep4.last_update.path == "reprepared"


def test_weight_validation(graphs):
    graph = graphs[1]
    prep = _prep(graph)              # unweighted
    with pytest.raises(ConfigError):
        apply_edge_updates(prep, inserts=[(0, 1)], insert_weights=[1.0])
    rng = np.random.default_rng(5)
    w = (rng.integers(1, 8, graph.m) / 4.0).astype(np.float32)
    wp = _prep(graph, weights=w)
    with pytest.raises(GraphValidationError):
        apply_edge_updates(wp, inserts=[_missing_edge(wp)])  # no weight


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def test_delete_missing_edge_rejected(graph):
    prep = _prep(graph)
    have = set(zip(prep.inv[src_of_edges(prep.graph)].tolist(),
                   prep.inv[prep.graph.indices].tolist()))
    missing = next((a, b) for a in range(graph.n) for b in range(graph.n)
                   if a != b and (a, b) not in have)
    with pytest.raises(GraphValidationError, match="not in the graph"):
        apply_edge_updates(prep, deletes=[missing])


def test_duplicate_and_conflicting_batches_rejected(graph):
    prep = _prep(graph)
    with pytest.raises(GraphValidationError):
        apply_edge_updates(prep, inserts=[(0, 1), (0, 1)])
    a = int(prep.inv[src_of_edges(prep.graph)[0]])
    b = int(prep.inv[prep.graph.indices[0]])
    with pytest.raises(GraphValidationError):
        apply_edge_updates(prep, inserts=[(a, b)], deletes=[(a, b)])


def test_out_of_range_edges_rejected(graph):
    prep = _prep(graph)
    with pytest.raises(GraphValidationError):
        apply_edge_updates(prep, inserts=[(0, graph.n)])
    with pytest.raises(GraphValidationError):
        apply_edge_updates(prep, inserts=[(-1, 0)])


def test_update_report_schema(graphs):
    pair = Pair(graphs)
    prep2 = pair.update(inserts=[_missing_edge(pair.t)])
    rep = prep2.last_update
    assert [f.name for f in dataclasses.fields(rep)] == \
        [f.name for f in dataclasses.fields(pair.j.last_update)]
    for f in ("path", "epoch", "n_inserted", "n_deleted", "n_reweighted",
              "sets_touched", "vss_rows_rewritten", "stale_edges",
              "reason"):
        assert hasattr(rep, f), f
    assert rep.n_inserted == 1 and rep.n_deleted == 0
    assert rep.epoch == prep2.epoch == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        rep.path = "other"
