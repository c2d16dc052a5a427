"""The port's autotuner (``repro_torch.core.autotune``) against the JAX
package's (``repro.core.autotune``), on the CPU.

The reference's autotune cases (``tests/test_hybrid.py``) run here on the
port: the memoisation contract (a second ``prepare(..., autotune=True)``
of the same class times nothing and re-serves the same knobs), the
``BLEST_AUTOTUNE=0`` hatch, autotuning off by default, bad reps, and the
``TileConfig`` round trip.  The parity case replaces ``_time_call`` in
both packages with one affine fake timer (``monkeypatch``; no file of the
reference changes), so both fit the same models and must pick the same
``TileConfig`` for σ in {4, 8} on two graph classes.
"""
import numpy as np
import pytest

import repro.core.autotune as jat
import repro_torch.core.autotune as tat
from repro.core.bfs import BlestProblem as JProblem
from repro.core.bvss import build_bvss as jbuild_bvss
from repro.graphs import generators as jgen
from repro_torch.core import reference_bfs
from repro_torch.core.autotune import TileConfig, clear_cache, stats, tune
from repro_torch.core.bfs import (DEFAULT_PUSH_CAP, BlestProblem,
                                  queue_widths)
from repro_torch.core.bvss import build_bvss
from repro_torch.core.policy import prepare
from repro_torch.errors import ConfigError
from repro_torch.graphs import generators as gen
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def fresh_tuner():
    clear_cache()
    jat.clear_cache()
    before = dict(stats)
    yield before
    clear_cache()
    jat.clear_cache()


def test_autotune_prepare_caches_winning_config(fresh_tuner):
    """Second prepare() of the same (device type, σ, size-class) times
    nothing and re-serves the same knobs."""
    g1, g2 = gen.grid2d(32, 32), gen.grid2d(31, 33)
    pb1 = prepare(g1, engine="blest", use_kernels=False, autotune=True,
                  device="cpu")
    assert isinstance(pb1.tile_config, TileConfig)
    assert pb1.tile_config.source == "tuned"
    runs_after_first = stats["tune_runs"]
    hits = stats["cache_hits"]
    pb2 = prepare(g2, engine="blest", use_kernels=False, autotune=True,
                  device="cpu")
    assert pb2.tile_config.source == "cached"
    assert stats["tune_runs"] == runs_after_first, "re-tuned a cached class"
    assert stats["cache_hits"] == hits + 1
    assert pb2.tile_config.pull_widths == pb1.tile_config.pull_widths
    assert pb2.tile_config.push_cap == pb1.tile_config.push_cap
    # the tuned engine still answers correctly
    for pb, g in ((pb1, g1), (pb2, g2)):
        np.testing.assert_array_equal(pb.levels(0), reference_bfs(g, 0))


def test_autotune_env_escape_hatch(fresh_tuner, monkeypatch):
    monkeypatch.setenv("BLEST_AUTOTUNE", "0")
    runs0 = stats["tune_runs"]
    p = BlestProblem.build(build_bvss(gen.grid2d(16, 16)), "cpu")
    cfg = tune(p, use_kernels=False)
    assert cfg.source == "disabled"
    assert stats["tune_runs"] == runs0, "BLEST_AUTOTUNE=0 still measured"
    assert cfg.pull_widths == tuple(queue_widths(p.num_vss, 2))
    assert cfg.push_cap == DEFAULT_PUSH_CAP


def test_autotune_off_by_default():
    pb = prepare(gen.path(64), engine="blest", use_kernels=False,
                 device="cpu")
    assert pb.tile_config is None


def test_autotune_rejects_bad_reps(fresh_tuner):
    p = BlestProblem.build(build_bvss(gen.path(64)), "cpu")
    with pytest.raises(ConfigError):
        tune(p, use_kernels=False, reps=0)


def test_tile_config_engine_kwargs_roundtrip():
    cfg = TileConfig(pull_widths=(128, 512), push_cap=256, alpha=4.0,
                     source="tuned")
    kw = cfg.engine_kwargs()
    assert kw == {"widths": [128, 512], "push_cap": 256, "alpha": 4.0}


def test_class_key_is_the_device_type():
    p = BlestProblem.build(build_bvss(gen.grid2d(16, 16), sigma=4), "cpu")
    assert tat.class_key(p, True) == ("cpu", 4, 64, True)


# one fake timer for both packages: t(w) = a + b * rows, per entry point
FAKE = {"pull": (3e-5, 2e-8), "push": (5e-5, 1e-7)}


def fake_time_call(calls: list):
    """``tune`` times the pull's two anchors, then the push's: the first
    two calls are the pull's.  Records (kind, rows) per call."""
    def _time_call(fn, args, reps):
        rows = int(args[0].shape[0])
        kind = "pull" if len(calls) < 2 else "push"
        calls.append((kind, rows))
        a, b = FAKE[kind]
        return a + b * rows
    return _time_call


@pytest.mark.parametrize("sigma", [4, 8])
@pytest.mark.parametrize("name", ["grid", "rmat"])
def test_tuned_config_matches_reference(fresh_tuner, monkeypatch, sigma,
                                        name):
    """The same fake timer in both packages: the same fitted models, the
    same ladder and push cap, and four timed calls in each."""
    graphs = {"grid": (jgen.grid2d(48, 40), gen.grid2d(48, 40)),
              "rmat": (jgen.rmat(9, 8, seed=3), gen.rmat(9, 8, seed=3))}
    jg, tg = graphs[name]
    jcalls, tcalls = [], []
    monkeypatch.setattr(jat, "_time_call", fake_time_call(jcalls))
    monkeypatch.setattr(tat, "_time_call", fake_time_call(tcalls))
    jp = JProblem.build(jbuild_bvss(jg, sigma=sigma))
    tp = BlestProblem.build(build_bvss(tg, sigma=sigma), "cpu")
    want = jat.tune(jp, use_kernels=False)
    got = tune(tp, use_kernels=False)
    assert (got.pull_widths, got.push_cap, got.alpha, got.source) == \
        (want.pull_widths, want.push_cap, want.alpha, want.source)
    assert tcalls == jcalls == [("pull", 128), ("pull", 2048),
                                ("push", 128), ("push", 2048)]
    # the fake slope is positive, so the ladder with the smallest rung wins
    assert got.pull_widths == tuple(queue_widths(tp.num_vss, 4))


@pytest.mark.parametrize("sigma", [1, 8, 32])
def test_timed_operands_equal_reference(sigma):
    """The synthetic operands are the reference's draws, bit for bit (the
    masks and frontier bytes as the port's int32 carriers)."""
    for w in (128, 2048):
        for name in ("_pull_operands", "_push_operands"):
            jm, jx = getattr(jat, name)(w, sigma, seed=w)
            tm, tx = getattr(tat, name)(w, sigma, w, "cpu")
            np.testing.assert_array_equal(tm.numpy().view(np.uint32),
                                          np.asarray(jm))
            want = np.asarray(jx)
            np.testing.assert_array_equal(tx.numpy().view(want.dtype), want)


def fake_slope(fn, args, reps):
    """A positive slope: the 4-bucket ladder (smallest rung) wins."""
    return 1e-5 + 1e-8 * int(args[0].shape[0])


def test_cached_ladder_fits_each_graph_of_the_class(fresh_tuner,
                                                    monkeypatch):
    """Two graphs of one size class (553 and 1,017 VSSs): the reference
    hands the second the first's ladder, whose top rung (the queue's
    capacity, 640) drops live VSSs of the second's wide levels; the port
    rebuilds the cached ladder for each graph's VSS count, and its levels
    equal the oracle."""
    from repro.core.bfs import make_blest_bfs as jmake
    from repro.core.bfs import reference_bfs as jref
    monkeypatch.setattr(jat, "_time_call", fake_slope)
    monkeypatch.setattr(tat, "_time_call", fake_slope)
    ja, jw = jgen.rmat(12, 8, seed=1), jgen.clustered(68, 60, p_in=0.4,
                                                      seed=4)
    ta, tw = gen.rmat(12, 8, seed=1), gen.clustered(68, 60, p_in=0.4, seed=4)
    jat.tune(JProblem.build(jbuild_bvss(ja)), use_kernels=False)
    jpw = JProblem.build(jbuild_bvss(jw))
    jcfg = jat.tune(jpw, use_kernels=False)
    assert jcfg.source == "cached" and jcfg.pull_widths[-1] < jpw.num_vss
    jfn = jmake(jpw, lazy=False, use_kernels=False, **jcfg.engine_kwargs())
    assert not np.array_equal(np.asarray(jfn(0)), jref(jw, 0))

    tune(BlestProblem.build(build_bvss(ta), "cpu"), use_kernels=False)
    pw = prepare(tw, order=False, engine="blest", use_kernels=False,
                 autotune=True, device="cpu")
    cfg = pw.tile_config
    assert cfg.source == "cached"
    assert cfg.pull_widths == tuple(queue_widths(pw.bvss.num_vss, 4))
    assert cfg.pull_widths[-1] >= pw.bvss.num_vss
    for s in (0, 100, 2000):
        np.testing.assert_array_equal(pw.levels(s), reference_bfs(tw, s))


def test_rebuild_refits_the_tuned_ladder(fresh_tuner, monkeypatch):
    """An update that grows the VSS count past the tuned ladder's top rung
    (grid2d(32, 32): 128 VSSs, one rung of 128): the next epoch's ladder
    is rebuilt for 129 VSSs, and its levels equal the oracle."""
    from repro_torch import apply_edge_updates
    from repro_torch.graphs import from_edges, src_of_edges
    monkeypatch.setattr(tat, "_time_call", fake_slope)
    g = gen.grid2d(32, 32)
    p = prepare(g, order=False, engine="blest", autotune=True,
                device="cpu")
    assert p.bvss.num_vss == 128 and p.tile_config.pull_widths == (128,)
    # from vertex 0, edges to every row its set lacks: the set's one VSS
    # overflows into a second
    have = {int(d) for s in range(8) for d in g.neighbours(s)}
    ins = [(0, d) for d in range(8, g.n) if d not in have][:129 - len(have)]
    p2 = apply_edge_updates(p, inserts=ins)
    assert p2.last_update.path == "rebuilt" and p2.bvss.num_vss == 129
    assert p2.tile_config.pull_widths == (128, 256)
    g2 = from_edges(g.n, src_of_edges(p2.graph), p2.graph.indices)
    for s in (0, 9, 1000):
        np.testing.assert_array_equal(p2.levels(s), reference_bfs(g2, s))
