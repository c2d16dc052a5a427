"""The port's span recorder (``repro_torch.tracing``) and the counters beside
it, on the CPU: nothing recorded and nothing allocated while tracing is
off; parents, request ids and self time while it is on; the clock shared
with ``torch.profiler``; the wave's spans against the engine's counters
(one ``wave.level`` a level, one ``wave.copy_wait`` a host copy); the
pull width and live-VSS counters recomputed level by level;
``GraphSession.counters()``; the kernel build span; and the benchmark's
trace arithmetic, which reads the same profiler events whether or not
program spans are recorded."""
import collections
import itertools
import os
import stat
import threading
import time
import tracemalloc

import numpy as np
import pytest

import repro_torch
from repro_torch import tracing
from repro_torch.core.bfs import BlestProblem, queue_widths, selected_width
from repro_torch.core.bvss import build_bvss
from repro_torch.core.multi_source import make_ms_engine
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import _build, launch_counts
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture
def recording():
    """Tracing on for one test, and off with nothing left behind after."""
    tracing.drain()
    tracing.enable()
    yield
    tracing.disable()
    tracing.drain()


def session(g, max_batch=4, **opts):
    return repro_torch.GraphSession(
        g, max_batch=max_batch,
        options=repro_torch.PrepareOptions(device="cpu", **opts))


def by_name(spans):
    return collections.Counter(s.name for s in spans)


def test_off_records_nothing_and_allocates_nothing():
    assert tracing.span("a") is tracing.span("b", request=3)
    with tracing.span("wave.level"):
        pass
    assert tracing.drain() == []
    loop = itertools.repeat(None, 1000)
    tracemalloc.start()
    try:
        tracing.span("warm")
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for _ in loop:
            with tracing.span("wave.level"):
                pass
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current == peak == base


def test_off_span_lets_exceptions_through():
    with pytest.raises(KeyError):
        with tracing.span("wave.level"):
            raise KeyError(1)


def test_parents_requests_and_self_time(recording):
    with tracing.span("a", request=7):
        with tracing.span("b"):
            with tracing.span("c"):
                time.sleep(0.001)
        with tracing.span("d"):
            time.sleep(0.001)
    with tracing.span("e"):
        pass
    spans = {s.name: s for s in tracing.drain()}
    assert tracing.drain() == []
    a, b, c, d, e = (spans[k] for k in "abcde")
    assert a.parent is None and e.parent is None
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert {a.request, b.request, c.request, d.request} == {7}
    assert e.request is None
    assert len({s.id for s in spans.values()}) == 5
    for inner, outer in ((b, a), (c, b), (d, a)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    own = tracing.self_ns(list(spans.values()))
    dur = {k: s.end_ns - s.start_ns for k, s in spans.items()}
    assert own[a.id] == dur["a"] - dur["b"] - dur["d"]
    assert own[b.id] == dur["b"] - dur["c"]
    assert own[c.id] == dur["c"] and own[e.id] == dur["e"]


def test_spans_of_two_threads_do_not_nest(recording):
    def work():
        with tracing.span("pump"):
            pass

    with tracing.span("main", request=1):
        th = threading.Thread(target=work)
        th.start()
        th.join(10.0)
        assert not th.is_alive()
    spans = {s.name: s for s in tracing.drain()}
    assert spans["pump"].parent is None and spans["pump"].request is None
    assert spans["pump"].thread != spans["main"].thread


def test_profiler_event_lands_inside_its_span(recording):
    """A ``record_function`` opened inside a program span lies inside that
    span on the span clock, to 50 µs at each end."""
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for i in range(5):
        with tracing.span(f"outer{i}"):
            with record_function(f"inner{i}"):
                time.sleep(0.002)
    prof.stop()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()}
    spans = {s.name: s for s in tracing.drain()}
    for i in range(5):
        ev, sp = events[f"inner{i}"], spans[f"outer{i}"]
        t0 = tracing.from_unix_ns(start_ns + ev.time_range.start * 1e3)
        t1 = tracing.from_unix_ns(start_ns + ev.time_range.end * 1e3)
        assert sp.start_ns - 50_000 <= t0 < t1 <= sp.end_ns + 50_000
        assert t1 - t0 >= 1_900_000            # the sleep is inside


@pytest.mark.parametrize("direction", ["pull", "auto"])
def test_wave_spans_follow_the_engine_counters(recording, direction):
    """One ``wave.level`` a counted level, one ``wave.copy_wait`` a host
    copy, every wave span under the batch's request id."""
    g = tgen.clustered(40, 60, p_in=0.4, seed=1)
    sess = session(g, direction=direction, order=False)
    tracing.drain()
    before = sess.counters()["wave"]
    roots = [0, 1111, 2399, 7]
    for root, lv in zip(roots, sess.levels_batch(roots)):
        np.testing.assert_array_equal(lv, repro_torch.reference_bfs(g, root))
    after = sess.counters()["wave"]
    spans = tracing.drain()
    n = by_name(spans)
    levels = sum(after[k] - before[k] for k in ("pull_levels", "push_levels"))
    assert n["wave.level"] == n["wave.step"] == n["wave.finalize"] == levels
    assert n["wave.copy_wait"] == after["host_syncs"] - before["host_syncs"]
    assert n["wave.batch"] == 1 and n["wave.deliver"] >= 1
    batch = next(s for s in spans if s.name == "wave.batch")
    assert batch.request is not None
    assert {s.request for s in spans} == {batch.request}
    if direction == "auto":
        assert after["push_levels"] > before["push_levels"]
    assert sess.levels_batch([1, 2]) and \
        {s.request for s in tracing.drain()} == {batch.request + 1}


def test_session_prepare_spans(recording):
    g = tgen.grid2d(17, 19)
    session(g)
    spans = tracing.drain()
    n = by_name(spans)
    for name in ("session.prepare", "session.bind", "prepare.order",
                 "prepare.permute", "prepare.bvss", "prepare.device"):
        assert n[name] == 1, name
    assert n["prepare.autotune"] == 0
    top = next(s for s in spans if s.name == "session.prepare")
    parents = {s.name: s.parent for s in spans}
    assert parents["session.bind"] == top.id
    assert parents["prepare.order"] == parents["prepare.device"] == top.id


def test_pull_counters_recomputed_level_by_level():
    g = tgen.rmat(11, 16, seed=1)
    problem = BlestProblem.build(build_bvss(g), "cpu")
    eng = make_ms_engine(problem, 4, direction="pull")
    widths = queue_widths(problem.num_vss, 2)
    assert len(widths) == 2
    st = eng.init(np.array([0, 1, 2, 3]))
    want_width = want_live = levels = 0
    picked = set()
    while st.cont:
        want_width += selected_width(widths, st.count)
        want_live += st.count
        picked.add(selected_width(widths, st.count))
        st, _ = eng.level_step(st)
        levels += 1
    assert eng.stats["pull_levels"] == levels > 0
    assert eng.stats["pull_width"] == want_width
    assert eng.stats["pull_live"] == want_live
    assert 0 < eng.stats["pull_live"] <= eng.stats["pull_width"]
    assert picked == set(widths)        # both graduations of the ladder


def test_counters_accessor_is_a_snapshot():
    g = tgen.grid2d(17, 19)
    sess = session(g)
    sess.levels_batch([0, 5, 9])
    got = sess.counters()
    assert got == {"wave": sess._ms.stats, "launches": launch_counts()}
    assert got["wave"]["pull_levels"] > 0
    sess.levels_batch([1, 2])
    assert got["wave"] != sess.counters()["wave"]


def test_build_span_only_when_something_compiles(recording, monkeypatch,
                                                 tmp_path):
    """``build_all`` returns nothing; it opens ``kernels.build`` around the
    compiler's jobs, and none when every library is there."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.build_all() is None
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        _build.library_path(s).name for s in _build.SOURCES)
    assert by_name(tracing.drain()) == {"kernels.build": 1}
    assert _build.build_all() is None
    assert tracing.drain() == []


def test_innermost_names_the_deepest_open_span():
    S = tracing.Span
    spans = [S("level", 1, None, None, 0, 0, 100),
             S("step", 2, 1, None, 0, 10, 40),
             S("copy_wait", 3, 1, None, 0, 60, 90),
             S("harvest", 4, None, None, 0, 120, 150)]
    points = [5, 20, 40, 50, 70, 110, 130, 200]
    names = [None if s is None else s.name
             for s in tracing.innermost(spans, points)]
    assert names == ["level", "step", "step", "level", "copy_wait", None,
                     "harvest", None]
    # idle gaps put down to the span open at their middle add up to the
    # whole idle time
    gaps = [(0, 8), (45, 55), (100, 118), (125, 135)]
    where = tracing.innermost(spans, [(a + b) / 2 for a, b in gaps])
    idle = collections.Counter()
    for (a, b), s in zip(gaps, where):
        idle["outside" if s is None else s.name] += b - a
    assert idle == {"level": 18, "outside": 18, "harvest": 10}
    assert sum(idle.values()) == sum(b - a for a, b in gaps)


def test_trace_summary_reads_the_same_events_with_spans_on():
    """Program spans add no profiler event, so ``blest_bench.trace``
    summarizes the same events whether or not they are recorded."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from blest_bench import trace
    g = tgen.grid2d(17, 19)
    sess = session(g)
    roots = [0, 5, 9, 100, 200]
    sess.levels_batch(roots)                                # warm

    def traced(on: bool):
        if on:
            tracing.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with record_function("slice"):
                    sess.levels_batch(roots)
        finally:
            tracing.disable()
        spans = tracing.drain()
        assert bool(spans) == on
        names = collections.Counter(e.name for e in prof.events())
        return names, trace.summarize(prof, "slice")

    names_off, off = traced(False)
    names_on, on = traced(True)
    assert names_on == names_off
    assert not any(k.startswith(("wave.", "session.", "prepare.",
                                 "kernels.")) for k in names_on)
    assert on.keys() == off.keys()
    for k in ("busy_s", "hand_busy_s", "hand_events"):
        assert on[k] == off[k]
    assert on["breakdown"]["device_ops"] == off["breakdown"]["device_ops"]
