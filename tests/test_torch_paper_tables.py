"""The paper's host tables, Figure 3, the RMAT scale sweep and the analytics
bench of the port (``repro_torch.bench``) against the JAX package.

Tables 1a, 1b and 4 are host statistics: every derived column of the
port's rows equals the reference module's row exactly (the time column is
a host time and is left out), at small sizes and at the reference's
defaults, where they also equal the rows ``chip_smoke.py`` holds the card
machine's host to.  Figure 3's permutations and compressions equal the
reference's for every window, and the port's BFS on each permuted graph
equals the reference oracle.  The scale sweep's footprint model equals the
reference's on the same prepared graph, and both JSON benches carry the
reference's keys.  Everything runs on the CPU (``device="cpu"``)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from benchmarks import table1a_compression as j1a
from benchmarks import table1b_divergence as j1b
from benchmarks import table4_footprint as j4
from repro.core import build_bvss as jbuild_bvss
from repro.core import reference_bfs as jreference_bfs
from repro.core.ordering import auto_order as jauto_order
from repro.core.ordering import jaccard_windows as jjaccard
from repro.core.ordering import shingle_order as jshingle
from repro.graphs import generators as jgen
from repro.kernels.ref import connected_components_ref as jcc_ref
from repro_torch.bench import (bench_analytics, bench_scale, common,
                               fig3_window, table1a_compression,
                               table1b_divergence, table4_footprint)
from repro_torch.core import build_bvss, make_engine
from repro_torch.core.ordering import jaccard_windows, shingle_order
from repro_torch.graphs import generators as gen

ROOT = Path(__file__).resolve().parents[1]
# the smoke script, for the rows it holds the card machine's host to
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these cases: their many small torch ops
    slow down by two orders of magnitude when the thread pools of parallel
    test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TABLES = {"table1a": (j1a, table1a_compression, "n"),
          "table1b": (j1b, table1b_divergence, "scale"),
          "table4": (j4, table4_footprint, "scale")}


def derived(rows):
    """{row name: derived column}: every column but the time."""
    return dict((name, rest) for name, _, rest in
                (r.split(",", 2) for r in rows))


@pytest.mark.parametrize("table,size", [
    ("table1a", 256), ("table1a", 1024), ("table1a", 4096),
    ("table1b", 6), ("table1b", 9), ("table1b", 11),
    ("table4", 6), ("table4", 8), ("table4", 11)])
def test_host_table_rows_equal_reference(table, size):
    jmod, tmod, key = TABLES[table]
    want = derived(jmod.run(verbose=False, **{key: size}))
    got = derived(tmod.run(verbose=False, device="cpu", **{key: size}))
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("table", sorted(TABLES))
def test_smoke_rows_equal_reference_at_default_size(table):
    """``chip_smoke.py`` holds the card machine's host to these rows: they
    are the reference's at its default sizes."""
    jmod = TABLES[table][0]
    want = derived(jmod.run(verbose=False))
    assert {k: v for k, v in chip_smoke.PAPER_TABLE_DERIVED.items()
            if k.startswith(table + "/")} == want


def test_vsp_msc_like_equals_reference():
    jg = j1a.vsp_msc_like(512, seed=3)
    tg = table1a_compression.vsp_msc_like(512, seed=3)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)


@pytest.mark.parametrize("name", sorted(jcommon.graph_suite(8)))
def test_connectivity_bits_equal_reference(name):
    jg = jcommon.graph_suite(8)[name]
    tg = common.graph_suite(8)[name]
    np.testing.assert_array_equal(tg.indices, jg.indices)
    tb, jb = build_bvss(tg), jbuild_bvss(jg)
    assert tb.connectivity_bits() == jb.connectivity_bits()
    assert tb.connectivity_bits() == tb.num_slices * tb.sigma


FIG3_WINDOWS = (8, 16, 32, 64, 128, 256)


@pytest.mark.parametrize("w", FIG3_WINDOWS)
def test_fig3_window_equals_reference(w):
    jg = jgen.clustered(4, 64, seed=4)
    tg = gen.clustered(4, 64, seed=4)
    jperm = jjaccard(jg, w=w, pre_order=jshingle(jg))
    perm = jaccard_windows(tg, w=w, pre_order=shingle_order(tg))
    np.testing.assert_array_equal(perm, jperm)
    gg = tg.permute_fast(perm)
    b = build_bvss(gg)
    assert b.compression_ratio() == jbuild_bvss(
        jg.permute_fast(jperm)).compression_ratio()
    fn = make_engine(gg, "blest", bvss=b, device="cpu")
    for s in np.random.default_rng(0).integers(0, tg.n, 3):
        lv = fn(int(perm[s])).numpy()[perm]
        np.testing.assert_array_equal(lv, jreference_bfs(jg, int(s)))


def test_fig3_rows_carry_reference_compressions():
    rows = derived(fig3_window.run(scale=8, verbose=False, device="cpu"))
    jg = jgen.clustered(4, 64, seed=4)
    pre = jshingle(jg)
    want = {f"fig3/w={w}": "compression=" + format(jbuild_bvss(
        jg.permute_fast(jjaccard(jg, w=w, pre_order=pre))
    ).compression_ratio(), ".3f") for w in FIG3_WINDOWS}
    assert rows == want


def reference_keys():
    with open(ROOT / "BENCH_pr10.json") as f:
        return json.load(f)


def test_bench_scale_equals_reference_footprint():
    out = bench_scale.run(scales=(9, 8), verbose=False, device="cpu")
    assert out["summary"]["all_verified"] is True
    assert out["summary"]["scales"] == [8, 9]
    ref = reference_keys()["scale_sweep"]
    assert set(out["scales"]) == {"8", "9"}
    for sc, row in out["scales"].items():
        assert list(row) == list(next(iter(ref["scales"].values())))
        # the reference's footprint model on the same prepared graph: its
        # own ordering and BVSS of the same RMAT graph
        jg = jgen.rmat(int(sc), 16, seed=1)
        perm, kind = jauto_order(jg, w=512)
        assert row["ordering"] == kind
        assert row["memory_bytes"] == jbuild_bvss(
            jg.permute_fast(perm)).memory_bytes()
        assert row["peak_memory_bytes"] == row["memory_bytes"]["total"]
        assert row["mteps"] > 0 and row["n"] == jg.n and row["m"] == jg.m
    assert list(out["summary"]) == list(ref["summary"])
    assert out["device"] == "cpu" and "card" not in out


def test_bench_analytics_verifies_and_counts_components():
    out = bench_analytics.run(scale=6, n_queries=4, n_pivots=2,
                              verbose=False, device="cpu")
    assert out["summary"]["all_verified"] is True
    ref = reference_keys()["analytics"]
    assert list(out["graphs"]) == list(ref["graphs"])
    assert list(out["summary"]) == list(ref["summary"])
    suite = jcommon.graph_suite(6)
    suite["frag"] = jgen.clustered(2, 32, p_out=0.0, seed=6)
    for gname, go in out["graphs"].items():
        want = {k: (list(v) if isinstance(v, dict) else None)
                for k, v in ref["graphs"][gname].items()}
        assert {k: (list(v) if isinstance(v, dict) else None)
                for k, v in go.items()} == want
        assert go["components"]["n_components"] == \
            int(jcc_ref(suite[gname]).max()) + 1, gname
        assert go["n"] == suite[gname].n and go["m"] == suite[gname].m


def test_benches_run_on_the_card_by_default(monkeypatch):
    from repro_torch.errors import ConfigError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (table1a_compression.run, table1b_divergence.run,
                table4_footprint.run, fig3_window.run, bench_scale.run,
                bench_analytics.run):
        with pytest.raises(ConfigError, match="no CUDA device"):
            run(verbose=False)
