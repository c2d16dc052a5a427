"""CPU tests of the benchmark's pieces: the generators against their
sources' rules, the plain reference against independent answers, the
traversed-edge count, the control, the trace arithmetic and the import
guard.  They import neither JAX nor the JAX package."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from blest_bench import components, control, inputs, reference, run, tiny, trace

BENCH_DIR = Path(__file__).resolve().parent
INF = reference.INF


def _family(name: str):
    return inputs.load_module(BENCH_DIR / "graphs" / f"{name}.py",
                              inputs.module_name("graph", name))


def test_kronecker_counts_and_initiator():
    params = {"scale": 10, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
              "D": 0.05}
    n, i, j = _family("kronecker").edge_tuples(params, np.random.default_rng(3))
    assert n == 1024 and len(i) == len(j) == 16 * 1024
    assert 0 <= min(i.min(), j.min()) and max(i.max(), j.max()) < n
    for bit in (0, 9):      # every level of the recursion draws the initiator
        q = np.bincount(2 * ((i >> bit) & 1) + ((j >> bit) & 1), minlength=4)
        np.testing.assert_allclose(q / len(i), [0.57, 0.19, 0.19, 0.05],
                                   atol=0.015)


def test_rgg_is_every_pair_within_the_radius():
    params = {"scale": 9, "radius_factor": 0.55}
    n, u, v = _family("rgg2d").edge_tuples(params, np.random.default_rng(5))
    pts = np.random.default_rng(5).random((n, 2))   # the generator's first draw
    r = 0.55 * np.sqrt(np.log(n) / n)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    want = {(a, b) for a, b in zip(*np.nonzero(np.triu(d2 < r * r, 1)))}
    got = {(min(a, b), max(a, b)) for a, b in zip(u.tolist(), v.tolist())}
    assert len(got) == len(u) and got == want


def test_rgg_edge_count_matches_the_unit_square_formula():
    n, u, _ = _family("rgg2d").edge_tuples(
        {"scale": 12, "radius_factor": 0.55}, np.random.default_rng(7))
    r = 0.55 * np.sqrt(np.log(n) / n)
    # chance that two uniform points of the unit square lie within r
    p = np.pi * r**2 - 8 / 3 * r**3 + r**4 / 2
    assert abs(len(u) / (n * (n - 1) / 2 * p) - 1) < 0.05


def test_simple_undirected_drops_loops_and_repeats():
    e = inputs.simple_undirected(5, np.array([0, 1, 2, 2, 3, 4]),
                                 np.array([1, 0, 2, 3, 2, 0]))
    assert e.n == 5 and e.a.tolist() == [0, 0, 2] and e.b.tolist() == [1, 4, 3]
    src, dst = e.directed()
    assert sorted(zip(src.tolist(), dst.tolist())) == \
        [(0, 1), (0, 4), (1, 0), (2, 3), (3, 2), (4, 0)]


def test_make_graph_is_one_relabelled_instance():
    cfg = json.loads((BENCH_DIR / "configs" / "rgg_n_2_20.json").read_text())
    cfg["generator"]["params"]["scale"] = 8
    g1 = inputs.make_graph(cfg, BENCH_DIR)
    g2 = inputs.make_graph(cfg, BENCH_DIR)
    assert np.array_equal(g1.a, g2.a) and np.array_equal(g1.b, g2.b)
    n, u, v = _family("rgg2d").edge_tuples(
        cfg["generator"]["params"],
        np.random.default_rng(cfg["generator"]["graph_seed"]))
    plain = inputs.simple_undirected(n, u, v)
    assert g1.m == plain.m and not np.array_equal(g1.a, plain.a)
    assert np.array_equal(np.sort(g1.degree()), np.sort(plain.degree()))
    # the run's seed draws the roots, not the graph
    assert not np.array_equal(inputs.Roots(g1, 11).batch(8),
                              inputs.Roots(g1, 2**31 + 5).batch(8))


def test_roots_distinct_and_of_degree_one_or_more():
    e = inputs.simple_undirected(6, np.array([0, 1, 3]), np.array([1, 2, 4]))
    batch = inputs.Roots(e, seed=9).batch(5)
    assert sorted(batch.tolist()) == [0, 1, 2, 3, 4]
    assert np.array_equal(inputs.Roots(e, 9).batch(3), inputs.Roots(e, 9).batch(3))


def test_reference_bfs_on_a_hand_made_graph():
    # path 0-1-2-3, a branch 1-4, an edge 5-6, vertex 7 alone
    e = inputs.simple_undirected(8, np.array([0, 1, 2, 1, 5]),
                                 np.array([1, 2, 3, 4, 6]))
    g = reference.csr(e.n, e.a, e.b)
    assert reference.bfs_levels(*g, 0).tolist() == [0, 1, 2, 3, 2, INF, INF, INF]
    assert reference.bfs_levels(*g, 6).tolist() == [INF] * 5 + [1, 0, INF]
    assert reference.bfs_levels(*g, 7).tolist() == [INF] * 7 + [0]


def test_reference_bfs_equals_scipy_hop_counts():
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import shortest_path
    rng = np.random.default_rng(1)
    e = inputs.simple_undirected(300, rng.integers(0, 300, 500),
                                 rng.integers(0, 300, 500))
    g = reference.csr(e.n, e.a, e.b)
    adj = coo_matrix((np.ones(e.m), (e.a, e.b)), shape=(e.n, e.n))
    for root in (0, 17, 299):
        want = shortest_path(adj, directed=False, unweighted=True, indices=root)
        want = np.where(np.isinf(want), INF, want).astype(np.int64)
        assert np.array_equal(reference.bfs_levels(*g, root), want)


def test_wrong_vertices_counts_differences_and_malformed_answers():
    want = np.array([0, 1, 2, INF], dtype=np.int32)
    assert reference.wrong_vertices(want.copy(), want) == 0
    assert reference.wrong_vertices(np.array([0, 1, 1, INF]), want) == 1
    assert reference.wrong_vertices(None, want) == 4
    assert reference.wrong_vertices(want[:3], want) == 4


def test_edges_of_component():
    # a triangle, a path of two edges, one vertex alone
    e = inputs.simple_undirected(7, np.array([0, 1, 2, 3, 4]),
                                 np.array([1, 2, 0, 4, 5]))
    assert components.edges_of_component(e.n, e.a, e.b).tolist() == \
        [3, 3, 3, 2, 2, 2, 0]


def test_graph500_cells_that_the_benchmark_names_are_not_added_twice(tmp_path):
    src = tmp_path / "src"
    (src / "blest_bench").mkdir(parents=True)
    (src / "blest_bench" / "configs").mkdir()
    (src / "blest_bench" / "graphs").mkdir()
    for f in ("configs/graph500_s17.json", "graphs/kronecker.py"):
        (src / "blest_bench" / f).write_bytes((BENCH_DIR / f).read_bytes())
    (src / "BENCHMARK.json").write_text(json.dumps({
        "configs": [dict(tiny.GRAPH500, source="Graph 500")],
        "workloads": [dict(tiny.EXTRA_CELLS[0], why="named")]}))
    bench = json.loads(
        (tiny.make_root(tmp_path / "dst", src=src) / "BENCHMARK.json").read_text())
    assert [c["name"] for c in bench["configs"]] == ["graph500_s17"]
    assert bench["configs"][0]["source"] == "Graph 500"
    assert [(w["name"], w["why"]) for w in bench["workloads"]] == \
        [("graph500_s17.wave64", "named"), ("graph500_s17.single", "a test")]
    cfg = json.loads((tmp_path / "dst" / bench["configs"][0]["file"]).read_text())
    assert cfg["generator"]["params"]["scale"] == 7


@pytest.mark.parametrize("workload", ["graph500_s17.wave64", "rgg_n_2_20.wave64"])
def test_control_is_called_wrong(tmp_path, workload):
    row = control.readings(tiny.make_root(tmp_path), workload, 2**31 + 7)
    assert row["checked_answers"] >= 1
    assert row["wrong_vertices_control"] > row["limit"] == 0


def _reader(name: str):
    return inputs.load_module(BENCH_DIR / "metrics" / f"{name}.py",
                              inputs.module_name("metric", name))


def _spans(seconds: dict) -> dict:
    return {k: {"n": 1, "s": v} for k, v in seconds.items()}


def test_metric_readers_on_a_known_record():
    rec = {"setup_s": 80.0, "prepare_s": 30.0, "traversed_edges": 4 * 10**9,
           "window": {"wall_s": 2.0, "attempted": 128, "failed": 0,
                      "batches": [(0.0, 0.1, 64, 0)] * 19 + [(0.0, 1.1, 64, 0)]},
           "counters": {"pull_levels": 90, "push_levels": 10, "host_syncs": 120,
                        "pull_width": 4000, "pull_live": 1200},
           "trace": {"window_s": 4.0, "busy_s": 3.0, "hand_busy_s": 0.6,
                     "hand_events": 50, "hand_launches": 50, "levels": 20,
                     "idle_under": {
                         "": 0.05, "wave.batch": 0.01,
                         "wave.batch/wave.refill": 0.1,
                         "wave.batch/wave.level/wave.step": 0.3,
                         "wave.batch/wave.level/wave.finalize/wave.copy_wait": 0.2,
                         "wave.batch/wave.harvest/wave.copy_wait": 0.04,
                         "wave.batch/wave.deliver": 0.16}},
           "spans": {"setup": _spans({
                         "prepare.order": 20.0, "prepare.permute": 1.5,
                         "prepare.bvss": 2.5, "prepare.device": 3.0,
                         "session.bind": 1.0, "kernels.load": 0.25,
                         "wave.batch": 4.0}),
                     "rest": _spans({"wave.batch": 1.9,
                                     "wave.copy_wait": 0.4})},
           "rest_counters": {"pull_levels": 45, "push_levels": 5,
                             "host_syncs": 60, "pull_width": 2000,
                             "pull_live": 600}}
    want = {"gteps": 2.0, "setup_s": 80.0, "prepare_s": 30.0,
            "wave_level_ms": 20.0, "syncs_per_level": 1.2,
            "hand_kernel_ms.wave": 30.0, "glue_share.wave": 0.8,
            "idle_share.wave": 0.25, "batch_p95_ms": 150.0,
            "prepare_order_s": 20.0, "prepare_bvss_s": 4.0,
            "prepare_device_s": 4.0, "kernel_load_s": 0.25,
            "wave_host_ms": 30.0, "copy_wait_ms": 8.0, "queue_fill.wave": 0.3,
            "level_idle_share.wave": 0.15, "harvest_idle_share.wave": 0.05}
    for name, value in want.items():
        assert _reader(name).read(rec) == pytest.approx(value), name
    # a build where nvcc ran counts with the loads
    rec["spans"]["setup"].update(_spans({"kernels.build": 16.0}))
    assert _reader("kernel_load_s").read(rec) == pytest.approx(16.25)
    # nothing to read: no spans, no trace, or launches the profiler did not see
    rec["spans"] = None
    assert all(_reader(m).read(rec) is None for m in
               ("prepare_order_s", "prepare_bvss_s", "prepare_device_s",
                "kernel_load_s", "wave_host_ms", "copy_wait_ms"))
    rec["spans"] = {"setup": _spans({"prepare.order": 20.0}), "rest": {}}
    assert _reader("kernel_load_s").read(rec) is None
    # a window that the traced slice took whole leaves no rest to read
    rec["spans"]["rest"] = _spans({"wave.batch": 1.9, "wave.copy_wait": 0.4})
    rec["rest_counters"] = None
    assert _reader("wave_host_ms").read(rec) is None
    assert _reader("copy_wait_ms").read(rec) is None
    rec["trace"] = None
    assert all(_reader(m).read(rec) is None for m in
               ("hand_kernel_ms.wave", "glue_share.wave", "idle_share.wave",
                "level_idle_share.wave", "harvest_idle_share.wave"))
    rec["counters"]["pull_width"] = 0
    assert _reader("queue_fill.wave").read(rec) is None
    rec["trace"] = {"window_s": 4.0, "busy_s": 3.0, "hand_busy_s": 0.6,
                    "hand_events": 49, "hand_launches": 50, "levels": 20}
    assert _reader("hand_kernel_ms.wave").read(rec) is None


def test_import_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping",
                                  "numpy"]) == []
    assert run.forbidden_modules(["repro.core.bfs", "jax.numpy", "jaxlib",
                                  "flax.linen", "repro_torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_reservoir_is_bounded_and_seeded():
    picks = []
    for _ in range(2):
        r = run.Reservoir(4, np.random.default_rng(3))
        for i in range(100):
            r.offer(i, None)
        picks.append([root for root, _ in r.items])
    assert r.seen == 100 and len(picks[0]) == 4 and picks[0] == picks[1]


def test_trace_arithmetic():
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    name = ("void (anonymous namespace)::bvss_spmm_quads<8>(unsigned int "
            "const*, unsigned int const*, int*)")
    assert trace.hand_kernel_name(name) == "bvss_spmm_quads<8>"
    assert trace.hand_kernel_name(
        "void at::native::(anonymous namespace)::where_kernel_impl()") is None
    cpu = [(0, 10, "outer"), (2, 4, "inner"), (6, 8, "other")]
    assert trace._host_labels(cpu, np.array([1, 3, 5, 7, 11])) == \
        ["outer", "inner", "outer", "other", "python"]


def test_idle_gaps_on_the_span_clock_by_the_spans_open():
    # the profiler's slice 100-200 µs is 5,000-105,000 ns on the span clock
    gaps = trace.on_span_clock([(100.0, 110.0), (150.0, 160.0)],
                               (100.0, 200.0), (5_000, 105_000))
    assert gaps == [(5_000.0, 15_000.0), (55_000.0, 65_000.0)]
    from repro_torch import tracing

    def S(name, sid, parent, start, end):
        return tracing.Span(name, sid, parent, None, 7, start, end)

    spans = [S("wave.batch", 1, None, 0, 100_000),
             S("wave.level", 2, 1, 1_000, 40_000),
             S("wave.step", 3, 2, 2_000, 30_000),
             S("wave.harvest", 4, 1, 40_000, 70_000),
             S("wave.copy_wait", 5, 4, 50_000, 69_000)]
    got = trace.idle_under(
        [(0, 500), (10_000, 20_000), (31_000, 33_000), (60_000, 61_000),
         (100_000, 104_000)], spans)
    assert got == pytest.approx({
        "wave.batch": 500e-9, "wave.batch/wave.level/wave.step": 10_000e-9,
        "wave.batch/wave.level": 2_000e-9,
        "wave.batch/wave.harvest/wave.copy_wait": 1_000e-9, "": 4_000e-9})
    # the harness's sweep names what the port's own does
    mids = [250, 15_000, 32_000, 60_500, 102_000]
    ours = trace._host_labels([(s.start_ns, s.end_ns, s.name) for s in spans],
                              mids, none=None)
    assert ours == [None if s is None else s.name
                    for s in tracing.innermost(spans, mids)]
