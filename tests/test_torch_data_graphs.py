"""The port's GNN and recsys batch builders and neighbour sampler
(``repro_torch.data.graphs``, ``repro_torch.data.sampler``; ROADMAP.md
queue 1 item 13d) against the JAX package's numpy originals.

For three seeds each: every array of ``full_graph_batch``,
``molecule_batch`` (the default triplet cap and a cap that binds) and
``recsys_batch``, and every field of ``NeighborSampler.sample``, equal to
the reference's bit for bit, dtypes included.  Then the reference tests'
properties on the port's builders (``tests/test_serve_data.py``), and
every index each builder makes in range: the models gather with them
(``x[idx]``, ``index_select``), which raise or clamp out of range where
JAX fills or drops.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import pytest

from repro.data import NeighborSampler as JNeighborSampler
from repro.data import graphs as JD
from repro.graphs import generators as jgen
from repro_torch.data import NeighborSampler, full_graph_batch, \
    molecule_batch, recsys_batch
from repro_torch.graphs import generators as gen
from torch_one_thread import one_torch_thread  # noqa: F401

SEEDS = (0, 3, 11)


def equal_fields(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed", SEEDS)
def test_full_graph_batch_equals_reference(seed):
    g, jg = gen.rmat(7, 6, seed=seed), jgen.rmat(7, 6, seed=seed)
    got = full_graph_batch(g, d_feat=16, n_classes=4, seed=seed)
    equal_fields(got, JD.full_graph_batch(jg, d_feat=16, n_classes=4,
                                          seed=seed))
    # the reference's properties, and every index in range
    assert got.node_feat.shape == (g.n + 1, 16)
    assert (got.node_feat[-1] == 0).all()       # dummy row zero
    assert got.senders.max() < g.n and got.receivers.max() < g.n
    assert got.senders.min() >= 0 and got.receivers.min() >= 0
    assert 0 <= got.labels.min() and got.labels.max() < 4
    assert not got.train_mask[-1]


@pytest.mark.parametrize("cap", [None, 6], ids=["default_cap", "cap6"])
@pytest.mark.parametrize("seed", SEEDS)
def test_molecule_batch_equals_reference(seed, cap):
    kw = dict(n_species=5, triplet_cap_per_graph=cap, seed=seed)
    got = molecule_batch(4, 10, 24, **kw)
    equal_fields(got, JD.molecule_batch(4, 10, 24, **kw))
    NB, E = 4 * 10, len(got.senders)
    assert len(got.t_kj) == 4 * (cap or 4 * 24)
    # triplet edges share the middle vertex j: receiver(kj) == sender(ji)
    live_t = (got.t_kj < E) & (got.t_ji < E)
    assert live_t.any()
    assert (got.senders[got.t_ji[live_t]]
            == got.receivers[got.t_kj[live_t]]).all()
    if cap is not None:
        assert live_t.all()                     # the cap binds
    # every index in range: node ids in [0, NB], edge ids in [0, E],
    # graph ids in [0, B], species in [0, n_species)
    for ids, hi in ((got.senders, NB), (got.receivers, NB),
                    (got.t_kj, E), (got.t_ji, E), (got.graph_ids, 4)):
        assert ids.min() >= 0 and ids.max() <= hi
    assert got.species.min() >= 0 and got.species.max() < 5
    assert got.graph_ids[-1] == 4 and got.species[-1] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_recsys_batch_equals_reference(seed):
    got = recsys_batch(512, 8, 100, seed=seed)
    want = JD.recsys_batch(512, 8, 100, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ids, labels = got
    assert ids.shape == (512, 8) and ids.min() >= 0 and ids.max() < 100
    assert 0.15 < labels.mean() < 0.85          # non-degenerate labels


@pytest.mark.parametrize("seed", SEEDS)
def test_neighbor_sampler_equals_reference(seed):
    g, jg = gen.rmat(8, 8, seed=1), jgen.rmat(8, 8, seed=1)
    sampler = NeighborSampler(g, fanouts=(5, 3), seed=seed)
    jsampler = JNeighborSampler(jg, fanouts=(5, 3), seed=seed)
    for seeds, mn, me in ((np.array([0, 1, 2]), 128, 256),
                          (np.arange(10, 40), 64, 96),     # both caps bind
                          (np.array([7]), 256, 512)):
        got = sampler.sample(seeds, max_nodes=mn, max_edges=me)
        equal_fields(got, jsampler.sample(seeds, max_nodes=mn, max_edges=me))
        # every edge endpoint a local id or the dummy mn, node ids -1 or
        # a vertex of g, the seeds first
        assert got.senders.min() >= 0 and got.senders.max() <= mn
        assert got.receivers.min() >= 0 and got.receivers.max() <= mn
        live = got.senders < mn
        assert (got.receivers[live] < mn).all()
        assert live.sum() == got.n_real_edges
        assert ((got.node_ids >= -1) & (got.node_ids < g.n)).all()
        assert (got.node_ids[:got.n_real_nodes] >= 0).all()
        assert got.seed_mask[:min(len(seeds), mn)].all()


def test_neighbor_sampler_is_bfs_frontier():
    g = gen.rmat(8, 8, seed=1)
    s = NeighborSampler(g, fanouts=(5, 3), seed=0)
    batch = s.sample(np.array([0, 1, 2]), max_nodes=128, max_edges=256)
    live = batch.senders < 128
    assert (batch.receivers[live] < 128).all()
    assert batch.seed_mask[:3].all()
    # edges really exist in the graph (in-neighbour direction)
    tp, ti = g.t_csr
    for s_l, d_l in zip(batch.senders[live][:50], batch.receivers[live][:50]):
        gs, gd = batch.node_ids[s_l], batch.node_ids[d_l]
        assert gs in ti[tp[gd]:tp[gd + 1]]
    # fanout bound: each node pulls at most fanout in-neighbours per hop
    c = Counter(batch.receivers[live].tolist())
    assert max(c.values()) <= 5 + 3  # seed hop + next hop can share a node
