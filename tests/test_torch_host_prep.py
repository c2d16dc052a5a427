"""Host preparation of the PyTorch port against the JAX reference: the same
graphs, orderings, BVSS arrays and device arrays, byte for byte."""
import numpy as np
import pytest
import torch

from repro.core import bvss as jbvss
from repro.core import ordering as jord
from repro.graphs import generators as jgen
from repro_torch.core import bvss as tbvss
from repro_torch.core import ordering as tord
from repro_torch.graphs import generators as tgen

SIGMAS = (1, 2, 4, 8, 16, 32)

#: small members of every generator family, built by each package's copy
FAMILIES = {
    "rmat": lambda gen: gen.rmat(7, 8, seed=1),
    "grid2d": lambda gen: gen.grid2d(9, 11),
    "grid2d_shuffled": lambda gen: gen.grid2d(8, 13, seed=3, shuffle=True),
    "star": lambda gen: gen.star(50),
    "path": lambda gen: gen.path(45),
    "clustered": lambda gen: gen.clustered(6, 20, seed=2),
    "rgg2d": lambda gen: gen.rgg2d(150, seed=4),
    "erdos_renyi": lambda gen: gen.erdos_renyi(70, 3.0, seed=5),
    "random_digraph": lambda gen: gen.random_digraph(60, 200, seed=6),
}
BVSS_FAMILIES = ("rmat", "grid2d", "star", "path", "clustered", "rgg2d")


def both(name):
    return FAMILIES[name](jgen), FAMILIES[name](tgen)


def assert_same_graph(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_generators_and_graph_views_byte_equal(name):
    jg, tg = both(name)
    assert_same_graph(jg, tg)
    for (ja, ta) in zip(jg.t_csr, tg.t_csr):
        np.testing.assert_array_equal(ja, ta)
        assert ja.dtype == ta.dtype
    assert_same_graph(jg.symmetrized, tg.symmetrized)
    perm = np.random.default_rng(0).permutation(jg.n)
    assert_same_graph(jg.permute_fast(perm), tg.permute_fast(perm))
    assert jg.bandwidth() == tg.bandwidth()


@pytest.mark.parametrize("sigma", [4, 8, 32])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_auto_order_byte_equal(name, sigma):
    jg, tg = both(name)
    jp, jkind = jord.auto_order(jg, sigma=sigma, w=64)
    tp, tkind = tord.auto_order(tg, sigma=sigma, w=64)
    assert jkind == tkind
    np.testing.assert_array_equal(jp, tp)
    assert jp.dtype == tp.dtype


@pytest.mark.parametrize("name", ["rmat", "clustered", "star"])
def test_ordering_primitives_byte_equal(name):
    jg, tg = both(name)
    np.testing.assert_array_equal(jord.rcm(jg), tord.rcm(tg))
    np.testing.assert_array_equal(jord.shingle_order(jg, seed=3),
                                  tord.shingle_order(tg, seed=3))
    pre = jord.shingle_order(jg)
    np.testing.assert_array_equal(
        jord.jaccard_windows(jg, sigma=4, w=32, pre_order=pre),
        tord.jaccard_windows(tg, sigma=4, w=32, pre_order=pre))
    assert (jord.social_like_report(jg).__dict__
            == tord.social_like_report(tg).__dict__)


def assert_same_bvss(jb, tb):
    for field in ("n", "m", "sigma", "tau", "n_sets", "num_vss",
                  "num_slices", "max_vss_per_set", "n_frontier_words"):
        assert getattr(jb, field) == getattr(tb, field), field
    for field in ("masks", "row_ids", "real_ptrs", "virtual_to_real"):
        ja, ta = getattr(jb, field), getattr(tb, field)
        assert ja.dtype == ta.dtype, field
        assert ja.shape == ta.shape, field
        assert ja.tobytes() == ta.tobytes(), field
    assert jb.update_divergence() == tb.update_divergence()
    assert jb.compression_ratio() == tb.compression_ratio()


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("name", BVSS_FAMILIES)
def test_bvss_and_device_arrays_byte_equal(name, sigma):
    jg, tg = both(name)
    perm, _ = jord.auto_order(jg, sigma=sigma, w=64)
    jb = jbvss.build_bvss(jg.permute_fast(perm), sigma=sigma)
    tb = tbvss.build_bvss(tg.permute_fast(perm), sigma=sigma)
    assert_same_bvss(jb, tb)

    jd = jbvss.to_device(jb)
    td = tbvss.to_device(tb, "cpu")
    assert td.masks.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jd.masks),
                                  td.masks.numpy().view(np.uint32))
    for field in ("row_ids", "virtual_to_real", "real_ptrs",
                  "vss_of_vertex_start", "vss_of_vertex_end"):
        ja = np.asarray(getattr(jd, field))
        ta = getattr(td, field).numpy()
        assert ja.dtype == ta.dtype, field
        np.testing.assert_array_equal(ja, ta, err_msg=field)


@pytest.mark.parametrize("sigma", [1, 8, 32])
@pytest.mark.parametrize("name", ["rmat", "clustered", "path"])
def test_bvss_from_arrays_round_trips(name, sigma):
    """The reference's host arrays, carried into the port, give the port's
    own build — and its edges reconstruct the graph."""
    jg, tg = both(name)
    jb = jbvss.build_bvss(jg, sigma=sigma)
    carried = tbvss.BVSS.from_arrays(
        jb.masks, jb.row_ids, jb.real_ptrs, jb.virtual_to_real,
        n=jb.n, m=jb.m, sigma=sigma)
    assert_same_bvss(jb, carried)
    assert_same_bvss(carried, tbvss.build_bvss(tg, sigma=sigma))
    src, dst = carried.reconstruct_edges()
    got = np.unique(src * tg.n + dst)
    want = np.unique(np.repeat(np.arange(tg.n), np.diff(tg.indptr))
                     * tg.n + tg.indices)
    np.testing.assert_array_equal(got, want)


def test_bvss_from_arrays_rejects_bad_arrays():
    from repro_torch.errors import GraphValidationError
    jb = jbvss.build_bvss(jgen.path(20), sigma=4)
    with pytest.raises(GraphValidationError, match="masks"):
        tbvss.BVSS.from_arrays(jb.masks.astype(np.int64), jb.row_ids,
                               jb.real_ptrs, jb.virtual_to_real,
                               n=jb.n, m=jb.m, sigma=4)
    with pytest.raises(GraphValidationError, match="row_ids"):
        tbvss.BVSS.from_arrays(jb.masks, jb.row_ids[:, :1], jb.real_ptrs,
                               jb.virtual_to_real, n=jb.n, m=jb.m, sigma=4)
    with pytest.raises(GraphValidationError, match="sigma"):
        tbvss.BVSS.from_arrays(jb.masks, jb.row_ids, jb.real_ptrs,
                               jb.virtual_to_real, n=jb.n, m=jb.m, sigma=3)
