"""Single-source BLEST of the PyTorch port against the JAX reference, on the
CPU: ``repro_torch.prepare(g, device="cpu").levels(s)`` must equal
``repro.prepare(g).levels(s)`` exactly, for both engines, every direction,
both queue ladders and the degenerate graphs, and the host decisions
(ordering, engine, parents) must match."""
import numpy as np
import pytest

import repro
import repro_torch
from repro.core.policy import parents_from_levels as j_parents
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro_torch.core.bfs import make_engine
from repro_torch.errors import ConfigError, GraphValidationError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.iinfo(np.int32).max


def clustered(gen):
    """The planted-partition graph of tests/test_hybrid.py: R >= 2 and an
    auto-mode frontier trace that takes both branches."""
    return gen.clustered(40, 60, p_in=0.4, seed=1)


def disconnected(mk):
    """Two directed cycles and two isolated vertices; n = 45 (not a
    multiple of 32 or of σ = 8)."""
    a = np.arange(20)
    src = np.concatenate([a, a + 20])
    dst = np.concatenate([(a + 1) % 20, (a + 1) % 20 + 20])
    return mk(45, src, dst)


GRAPHS = {
    "clustered": (clustered(jgen), clustered(tgen)),
    "grid2d": (jgen.grid2d(13, 17), tgen.grid2d(13, 17)),
    "rmat": (jgen.rmat(8, 8, seed=1), tgen.rmat(8, 8, seed=1)),
    "star": (jgen.star(70), tgen.star(70)),
    "disconnected": (disconnected(j_from_edges),
                     disconnected(t_from_edges)),
    "single_vertex": (jgen.path(1), tgen.path(1)),
}


def prepared_pair(name, **opts):
    jg, tg = GRAPHS[name]
    jp = repro.prepare(jg, options=repro.PrepareOptions(**opts))
    tp = repro_torch.prepare(
        tg, options=repro_torch.PrepareOptions(device="cpu", **opts))
    return jp, tp


def sources(n):
    return sorted({0, n // 2, n - 1})


def assert_same_levels(jp, tp, srcs):
    assert tp.ordering == jp.ordering
    assert tp.engine_name == jp.engine_name
    np.testing.assert_array_equal(tp.perm, jp.perm)
    for s in srcs:
        want = jp.levels(s)
        got = tp.levels(s)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"source {s}")


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
@pytest.mark.parametrize("engine", ["blest", "blest_lazy"])
def test_engines_and_directions_match_reference(engine, direction):
    jp, tp = prepared_pair("clustered", engine=engine, direction=direction)
    assert tp.problem.max_vss_per_set >= 2
    assert_same_levels(jp, tp, sources(tp.graph.n))


@pytest.mark.parametrize("buckets", [1, 2])
@pytest.mark.parametrize("name", ["grid2d", "rmat"])
def test_default_path_and_buckets_match_reference(name, buckets):
    jp, tp = prepared_pair(name, buckets=buckets)
    assert_same_levels(jp, tp, sources(tp.graph.n))


@pytest.mark.parametrize("sigma", [1, 4, 32])
def test_sigma_sweep_matches_reference(sigma):
    jp, tp = prepared_pair("rmat", sigma=sigma)
    assert_same_levels(jp, tp, [0, 77])


@pytest.mark.parametrize("engine", ["blest", "blest_lazy"])
@pytest.mark.parametrize("name", ["star", "disconnected", "single_vertex"])
def test_degenerate_graphs_match_reference(name, engine):
    """Unreached vertices stay INF; an isolated source reaches only itself;
    a one-vertex graph has one level."""
    jp, tp = prepared_pair(name, engine=engine)
    n = tp.graph.n
    srcs = sources(n) + ([40, 44] if name == "disconnected" else [])
    assert_same_levels(jp, tp, srcs)
    if name == "disconnected":
        lv = tp.levels(44)                  # isolated vertex
        assert lv[44] == 0 and (np.delete(lv, 44) == INF).all()


def test_twin_path_matches_kernel_entry_points():
    """use_kernels=False (the twins called directly) gives the same levels
    as the kernel entry points, and as the reference's jnp path."""
    jp, tp = prepared_pair("clustered", use_kernels=False)
    _, tk = prepared_pair("clustered")
    assert_same_levels(jp, tp, [0, 1111])
    for s in (0, 1111):
        np.testing.assert_array_equal(tp.levels(s), tk.levels(s))


def test_parents_match_reference():
    jp, tp = prepared_pair("clustered")
    jg, tg = GRAPHS["clustered"]
    for s in (0, 1500):
        lv = tp.levels(s)
        np.testing.assert_array_equal(
            repro_torch.parents_from_levels(tg, lv), j_parents(jg, lv))


def test_auto_mode_takes_both_branches():
    """On the planted-partition graph in its natural order (the setting of
    tests/test_hybrid.py::test_auto_mode_genuinely_flips), auto mode pushes
    on some levels and pulls on others — and equals the reference."""
    from repro.core.bfs import make_engine as j_make_engine
    from repro_torch.core.bfs import BlestProblem
    from repro_torch.core.bvss import build_bvss
    from repro_torch.kernels import pull_vss_kernel, push_vss_kernel
    jg, tg = GRAPHS["clustered"]
    problem = BlestProblem.build(build_bvss(tg), "cpu")
    calls = {"pull": 0, "push": 0}

    def spy(kind, fn):
        def wrapped(*args):
            calls[kind] += 1
            return fn(*args)
        return wrapped

    bfs = make_engine(tg, "blest", problem=problem,
                      pull_impl=spy("pull", pull_vss_kernel),
                      push_impl=spy("push", push_vss_kernel))
    lv = bfs(0).numpy()
    assert calls["pull"] > 0 and calls["push"] > 0, calls
    np.testing.assert_array_equal(
        lv, np.asarray(j_make_engine(jg, "blest", direction="auto")(0)))


def test_max_levels_stops_early():
    _, tp = prepared_pair("grid2d")
    src = int(tp.perm[0])
    full = repro_torch.reference_bfs(tp.graph, src)
    bfs = make_engine(tp.graph, "blest", problem=tp.problem)
    from repro_torch.core.bfs import make_blest_bfs
    cut = make_blest_bfs(tp.problem, lazy=False, max_levels=3)(src).numpy()
    np.testing.assert_array_equal(cut, np.where(full <= 3, full, INF))
    np.testing.assert_array_equal(bfs(src).numpy(), full)


def test_prepare_keyword_fields_and_validation():
    tg = GRAPHS["rmat"][1]
    a = repro_torch.prepare(tg, device="cpu", engine="blest_lazy")
    b = repro_torch.prepare(tg, options=repro_torch.PrepareOptions(
        device="cpu", engine="blest_lazy"))
    assert a.engine_name == b.engine_name == "blest_lazy"
    np.testing.assert_array_equal(a.levels(3), b.levels(3))
    with pytest.raises(TypeError):
        repro_torch.prepare(tg, device="cpu", mesh=None)
    with pytest.raises(GraphValidationError):
        a.levels(tg.n)
    with pytest.raises(GraphValidationError):
        a.levels(-1)
    with pytest.raises(ConfigError):
        repro_torch.prepare(tg, device="cpu", direction="sideways")
    with pytest.raises(ConfigError, match="unknown engine"):
        repro_torch.prepare(tg, device="cpu", engine="warp_bfs")
