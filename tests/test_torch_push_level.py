"""The one-launch push level of the PyTorch port on the CPU.

``bvss_push_level`` (CPU tensors run its twin ``bvss_push_level_ref``)
must leave in levels / marks exactly what the unfused push level leaves
there: ``compact_vertices → expand_push_queue → bvss_push_ref →
scatter``, as the engine's step runs it with a push function.  Levels and marks are
integers, so the comparison is exact; slot n (the dummy row the unfused
scatter aims its misses at, read by nobody) is left out.  The port's
BLEST engines, whose push levels now take ``bvss_push_level``, must equal
the JAX reference (``repro.core.bfs``, Pallas kernels in interpret mode)
level for level.  The CUDA kernel is held against the twin by
``tests/test_torch_cuda.py`` (skipped without a card) and
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import repro
import repro_torch
import repro_torch.core.bfs as tbfs
import repro_torch.kernels as tk
from repro.graphs import from_edges as j_from_edges
from repro.graphs import generators as jgen
from repro_torch.core.bvss import build_bvss
from repro_torch.errors import ConfigError
from repro_torch.graphs import from_edges as t_from_edges
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import src_of_edges
from repro_torch.kernels import ref as tref
from torch_one_thread import one_torch_thread  # noqa: F401

INF = np.int32(np.iinfo(np.int32).max)
ISOLATED = 40                    # vertices with no edge, appended to a grid
LVL = 5


def grid_isolated(gen, mk):
    """grid2d(20, 20) and ISOLATED vertices with no edge after it (n = 440):
    R = 1 for σ ≤ 16, and slice sets with no VSS at every σ."""
    g = gen.grid2d(20, 20)
    return mk(g.n + ISOLATED, src_of_edges(g), g.indices)


def clustered(gen):
    """The planted-partition graph of tests/test_hybrid.py: R >= 2 from
    σ = 8."""
    return gen.clustered(40, 60, p_in=0.4, seed=1)


GRAPHS = {"grid_isolated": lambda: grid_isolated(tgen, t_from_edges),
          "clustered": lambda: clustered(tgen)}


def problem_of(name, sigma):
    return tbfs.BlestProblem.build(build_bvss(GRAPHS[name](), sigma=sigma),
                                   "cpu")


def frontier(p, kind, rng):
    """Packed frontier words of ``kind``: one vertex with out-edges; the
    auto cap's DEFAULT_PUSH_CAP vertices; several hundred (a forced push).
    The last two hold the graph's last vertex, whose slice set is empty on
    ``grid_isolated``."""
    n = p.n
    size = {"one": 1, "cap": tbfs.DEFAULT_PUSH_CAP, "forced": 300}[kind]
    if kind == "one":
        verts = np.array([n // 3])
    else:
        verts = np.append(rng.choice(n - 1, size - 1, replace=False), n - 1)
    bits = torch.zeros(p.n_fwords * 32, dtype=torch.bool)
    bits[torch.from_numpy(verts)] = True
    return tref.pack_words(bits)


def start_state(p, F, rng, lazy):
    """A level state before the push of level LVL: levels mixing INF,
    levels below, at and above LVL; marks holding stale values."""
    n = p.n
    levels = torch.from_numpy(rng.choice(
        np.array([INF, 2, LVL - 1, LVL, LVL + 2], np.int32), n + 1,
        p=[0.6, 0.1, 0.1, 0.1, 0.1]))
    marks = torch.from_numpy(rng.integers(0, 3, n + 1 if lazy else 1
                                          ).astype(np.uint8))
    return tbfs._BlestState(levels, F, None, 0, marks, n, 0, True)


def push_step(p, push, lazy, cap):
    """The engine's forced push step: ``push=None`` the one-launch level,
    else the unfused path around ``push``."""
    return tbfs._make_hybrid_step(
        p.dev, tbfs.pull_vss_twin, push, p.sigma, p.n,
        tbfs.queue_widths(p.num_vss, 2), lazy=lazy, direction="push",
        num_vss=p.num_vss, n_fwords=p.n_fwords, dummy_vertex=p.n,
        R=p.max_vss_per_set, push_cap=cap, alpha=4.0)


def clone(state):
    return state._replace(levels=state.levels.clone(),
                          marks=state.marks.clone())


@pytest.mark.parametrize("kind", ["one", "cap", "forced"])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("sigma", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("name", ["grid_isolated", "clustered"])
def test_push_level_twin_equals_unfused_path(name, sigma, lazy, kind):
    p = problem_of(name, sigma)
    # R = 1 on the grid up to σ = 8 and on the clusters up to σ = 4; R >= 2
    # on the clusters from σ = 8 and on the grid at σ = 32
    wide = sigma >= (8 if name == "clustered" else 32)
    assert (p.max_vss_per_set >= 2) == wide, p.max_vss_per_set
    dev = p.dev
    if name == "grid_isolated":
        assert int(dev.vss_of_vertex_start[p.n - 1]) == int(
            dev.vss_of_vertex_end[p.n - 1])
    rng = np.random.default_rng(sigma * 100 + lazy * 10 + len(kind))
    F = frontier(p, kind, rng)
    state = start_state(p, F, rng, lazy)
    # the auto cap for the small frontiers, n for the forced one
    cap = p.n if kind == "forced" else tbfs.DEFAULT_PUSH_CAP
    want = push_step(p, tref.bvss_push_ref, lazy, cap)(clone(state), LVL)
    got = clone(state)
    operands = (F, dev.vss_of_vertex_start, dev.vss_of_vertex_end,
                dev.masks, dev.row_ids, LVL)
    if lazy:
        out = tref.bvss_push_level_ref(*operands, p.sigma,
                                       marks=got.marks.zero_())
        assert out is got.marks
        np.testing.assert_array_equal(got.marks[:p.n].numpy(),
                                      want.marks[:p.n].numpy())
        assert got.marks[:p.n].any()
    else:
        out = tref.bvss_push_level_ref(*operands, p.sigma,
                                       levels=got.levels)
        assert out is got.levels
        np.testing.assert_array_equal(got.levels[:p.n].numpy(),
                                      want.levels[:p.n].numpy())
        assert not torch.equal(got.levels, state.levels)
    # the engine's step with push=None (the entry on CPU tensors) too
    step = push_step(p, None, lazy, cap)(clone(state), LVL)
    np.testing.assert_array_equal(step.levels[:p.n].numpy(),
                                  want.levels[:p.n].numpy())
    np.testing.assert_array_equal(step.marks[:p.n].numpy(),
                                  want.marks[:p.n].numpy())


@pytest.mark.parametrize("lazy", [False, True])
def test_push_level_empty_slice_set_is_a_no_op(lazy):
    """A frontier of one vertex whose slice set has no VSS stores nothing."""
    p = problem_of("grid_isolated", 8)
    F = torch.zeros(p.n_fwords, dtype=torch.int32)
    F[(p.n - 1) // 32] = int(np.int32(np.uint32(1 << ((p.n - 1) % 32))))
    levels = torch.full((p.n + 1,), INF, dtype=torch.int32)
    marks = torch.zeros(p.n + 1, dtype=torch.uint8)
    dev = p.dev
    tk.bvss_push_level(F, dev.vss_of_vertex_start, dev.vss_of_vertex_end,
                       dev.masks, dev.row_ids, LVL, sigma=8,
                       **({"marks": marks} if lazy else {"levels": levels}))
    assert (levels == INF).all() and (marks == 0).all()


def test_push_level_entry_validation_and_counts():
    """Exactly one of levels= and marks=; a twin call is no launch."""
    p = problem_of("grid_isolated", 8)
    dev = p.dev
    F = frontier(p, "one", np.random.default_rng(0))
    args = (F, dev.vss_of_vertex_start, dev.vss_of_vertex_end, dev.masks,
            dev.row_ids, LVL)
    levels = torch.full((p.n + 1,), INF, dtype=torch.int32)
    marks = torch.zeros(p.n + 1, dtype=torch.uint8)
    with pytest.raises(ConfigError, match="exactly one"):
        tk.bvss_push_level(*args, sigma=8)
    with pytest.raises(ConfigError, match="exactly one"):
        tk.bvss_push_level(*args, sigma=8, levels=levels, marks=marks)
    before = tk.launch_counts()
    assert tk.bvss_push_level(*args, sigma=8, levels=levels) is levels
    assert tk.launch_counts() == before
    assert "bvss_push_level" in before
    assert (levels[:p.n] == LVL).sum() > 0


JAX_GRAPHS = {
    "grid_isolated": (grid_isolated(jgen, j_from_edges),
                      grid_isolated(tgen, t_from_edges)),
    "rmat": (jgen.rmat(8, 8, seed=1), tgen.rmat(8, 8, seed=1)),
}


@pytest.mark.parametrize("direction", ["push", "auto"])
@pytest.mark.parametrize("engine", ["blest", "blest_lazy"])
@pytest.mark.parametrize("name", ["grid_isolated", "rmat"])
def test_push_level_engines_match_reference(name, engine, direction):
    """The port's BLEST engines, whose push levels run bvss_push_level,
    equal the JAX engines level for level: natural order on the grid (its
    isolated vertices keep their empty slice sets), σ = 32 on rmat."""
    jg, tg = JAX_GRAPHS[name]
    opts = dict(engine=engine, direction=direction)
    if name == "grid_isolated":
        opts["order"] = False
    else:
        opts["sigma"] = 32
    jp = repro.prepare(jg, options=repro.PrepareOptions(**opts))
    tp = repro_torch.prepare(
        tg, options=repro_torch.PrepareOptions(device="cpu", **opts))
    for s in (0, 210, tg.n - 1):
        want = jp.levels(s)
        got = tp.levels(s)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"source {s}")


def spy(calls, kind, fn):
    def wrapped(*args, **kwargs):
        calls[kind] += 1
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("direction", ["push", "auto"])
def test_push_routes(monkeypatch, direction):
    """use_kernels=True with no push_impl pushes through bvss_push_level;
    push_impl= takes the unfused seam; use_kernels=False the unfused twin.
    All three give the host oracle's levels."""
    g = clustered(tgen)
    problem = tbfs.BlestProblem.build(build_bvss(g), "cpu")
    calls = {"level": 0, "seam": 0, "twin": 0}
    monkeypatch.setattr(tbfs, "bvss_push_level",
                        spy(calls, "level", tk.bvss_push_level))
    monkeypatch.setattr(tbfs, "bvss_push_ref",
                        spy(calls, "twin", tref.bvss_push_ref))
    want = repro_torch.reference_bfs(g, 0)

    def run(**kw):
        lv = tbfs.make_blest_bfs(problem, lazy=False, direction=direction,
                                 **kw)(0).numpy()
        np.testing.assert_array_equal(lv, want)
        got = dict(calls)
        calls.update(level=0, seam=0, twin=0)
        return got

    fused = run()
    assert fused["level"] > 0 and fused["seam"] == fused["twin"] == 0
    seam = run(push_impl=spy(calls, "seam", tk.push_vss_kernel))
    assert seam["seam"] > 0 and seam["level"] == seam["twin"] == 0
    twin = run(use_kernels=False)
    assert twin["twin"] > 0 and twin["level"] == twin["seam"] == 0
