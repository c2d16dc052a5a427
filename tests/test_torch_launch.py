"""The port's launcher and bench scripts on the CPU.

``repro_torch.launch.bfs.main([..., "--device", "cpu"])`` must run every
Table-2 variant of the reference launcher to ``VERIFIED vs oracle``, on
the reference's graphs and variant table; ``--service`` with
``--devices`` serves on spawned gloo ranks; without ``--device cpu`` the
launcher asks for the card.
The bench scripts (``repro_torch.bench``) run end to end at a small size,
each checking its engines or kernels against the oracles or twins."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import bfs as jlaunch
from repro_torch.bench import (bench_queue, bench_service, kernel_bench,
                               table2_bfs)
from repro_torch.errors import ConfigError
from repro_torch.launch import bfs as tlaunch
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_engine_variants_match_reference():
    assert tlaunch.ENGINE_VARIANTS == jlaunch.ENGINE_VARIANTS
    # the reference bench's row order: CSR baselines, BRS, then BLEST
    assert table2_bfs.VARIANTS == ("csr_push", "csr_pull", "dirop", "brs",
                                   "blest_a", "blest_ab", "blest_ac",
                                   "blest_full")


@pytest.mark.parametrize("name", ["rmat", "urand", "road", "clustered"])
def test_build_graph_matches_reference(name):
    jg = jlaunch.build_graph(name, 8, seed=3)
    tg = tlaunch.build_graph(name, 8, seed=3)
    assert tg.n == jg.n
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)


@pytest.mark.parametrize("variant", sorted(jlaunch.ENGINE_VARIANTS))
def test_cli_verifies_every_variant_on_cpu(variant, capsys):
    tlaunch.main(["--graph", "road", "--scale", "8", "--engine", variant,
                  "--sources", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(f"[bfs] {variant}: ")
    assert out[-1].endswith("VERIFIED vs oracle"), out[-1]
    assert "device=cpu" in out[0]


@pytest.mark.parametrize("flag", [["--devices", "2", "--service"],
                                  ["--devices", "2", "--service",
                                   "--queue"]])
def test_unported_flags_raise(flag):
    """No flag of the launcher is refused any more: ``--service`` (and
    ``--queue``) with ``--devices 2`` serves through a session on a mesh
    of two spawned gloo ranks, rank 0 printing once, and verifies every
    answer against the oracle."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bfs", "--graph", "road",
         "--scale", "6", "--engine", "blest_full", "--sources", "4",
         "--device", "cpu", "--verify-fraction", "1.0", *flag],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].endswith("device=cpu mesh=2x1"), lines
    assert lines[1].startswith("[bfs] session up: "), lines
    if "--queue" in flag:
        assert lines[2].startswith("[bfs] queue: 4 completed"), lines
    assert len(lines) == 3 + ("--queue" in flag), lines
    assert lines[-1].startswith("[bfs] service: 4 queries, "), lines
    assert "quarantines=0" in lines[-1], lines[-1]
    assert lines[-1].endswith("VERIFIED vs oracle"), lines[-1]


@pytest.mark.parametrize("flags", [
    ["--service"], ["--service", "--max-batch", "8"],
    ["--service", "--queue"], ["--service", "--deadline-s", "3600"],
    ["--service", "--verify-fraction", "1.0"],
    ["--service", "--max-batch", "8", "--queue", "--verify-fraction",
     "1.0"]], ids=["service", "max-batch", "queue", "deadline-s",
                   "verify-fraction", "all"])
def test_service_flags_verify_on_cpu(flags, capsys):
    """The serving tier's five flags run to ``VERIFIED vs oracle``; the
    books they print equal the reference launcher's."""
    argv = ["--graph", "road", "--scale", "8", "--engine", "blest_full",
            "--sources", "6", *flags]
    tlaunch.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("[bfs] service: 6 queries, ")
    assert out[-1].endswith("VERIFIED vs oracle"), out[-1]
    jlaunch.main(argv)
    ref = capsys.readouterr().out.strip().splitlines()
    # the same books: partial, verified and quarantine counts (and the
    # queue's waves and coalescing), not the times
    assert out[-1].split("(")[-1] == ref[-1].split("(")[-1]
    if "--queue" in flags:
        assert out[-2] == ref[-2] and out[-2].startswith("[bfs] queue: ")


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        tlaunch.main(["--graph", "road", "--scale", "6", "--engine", "brs"])


def test_table2_bench_runs_every_variant():
    rows = table2_bfs.run(scale=6, n_sources=2, device="cpu", verbose=False)
    assert len(rows) == 6 * len(table2_bfs.VARIANTS)
    brs = [r for r in rows if "/brs," in r]
    assert brs and all("speedup_vs_brs=1.00x" in r for r in brs)


def test_variant_engines_reuse_an_ordered_preparation():
    import repro_torch
    g = repro_torch.generators.clustered(6, 32, seed=4)
    ordered = repro_torch.prepare(g, device="cpu")
    variants = table2_bfs.variant_engines(g, device="cpu", ordered=ordered)
    assert variants["blest_full"].core == ordered.engine_name
    assert variants["blest_ab"].engine is not ordered._fn
    for name, v in variants.items():
        np.testing.assert_array_equal(v.levels(5),
                                      repro_torch.reference_bfs(g, 5),
                                      err_msg=name)


def test_service_bench_multi_source_section():
    out = bench_service.run(scale=6, n_queries=4, device="cpu",
                            verbose=False)
    assert out["device"] == "cpu" and len(out["graphs"]) == 6
    for go in out["graphs"].values():
        ms = go["multi_source"]
        assert ms["n_sources"] == 4
        assert ms["dense_adjacency_bytes"] == go["n"] * (
            (go["n"] + 31) // 32) * 4


def _reference_suite(name):
    """The reference bench's JSON section ``name`` (``BENCH_pr10.json``)."""
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    return json.loads((root / "BENCH_pr10.json").read_text())[name]


def _same_keys(out, ref):
    assert set(out["summary"]) == set(ref["summary"])
    assert set(out["graphs"]) == set(ref["graphs"])
    for gname, go in out["graphs"].items():
        rg = ref["graphs"][gname]
        assert set(go) == set(rg), gname
        for sec, val in go.items():
            if isinstance(val, dict):
                assert set(val) == set(rg[sec]), (gname, sec)


def test_service_bench_serve_and_hardened_sections(tmp_path):
    """All three sections, verified, with the reference bench's keys, and
    its JSON written."""
    path = tmp_path / "service.json"
    out = bench_service.run(scale=6, n_queries=4, device="cpu",
                            json_path=str(path), verbose=False)
    _same_keys(out, _reference_suite("service"))
    assert out["summary"]["all_verified"] is True
    for go in out["graphs"].values():
        assert go["serve"]["verified"] and go["hardened"]["verified"]
        assert go["serve"]["max_batch"] == 4
    import json
    assert json.loads(path.read_text())["summary"] == out["summary"]


def test_queue_bench_runs_verified(tmp_path):
    path = tmp_path / "queue.json"
    out = bench_queue.run(scale=6, n_requests=6, max_batch=4, device="cpu",
                          json_path=str(path), verbose=False)
    _same_keys(out, _reference_suite("queue"))
    assert out["device"] == "cpu"
    assert out["summary"]["all_verified"] is True
    assert out["summary"]["total_coalesced"] > 0
    import json
    assert json.loads(path.read_text())["summary"] == out["summary"]


def test_kernel_bench_rows():
    rows = kernel_bench.run("cpu", n_vertices=3000, verbose=False)
    names = [r.split(",")[0] for r in rows]
    assert names == ["kernel/bvss_pull[cpu]", "kernel/bvss_pull[twin]",
                     "kernel/bit_spmm[cpu]", "kernel/bit_spmm[twin]",
                     "kernel/finalize_sweep[cpu]",
                     "kernel/finalize_sweep[twin]",
                     "kernel/finalize_pack_sweep_lazy[cpu]",
                     "kernel/finalize_pack_sweep_lazy[twin]"]


def test_hybrid_bench_runs_verified(tmp_path):
    """The hybrid bench at a small scale on the CPU: every graph verified
    in all three direction modes, the reference bench's keys
    (``BENCH_pr7.json``'s ``hybrid`` section), one tuning run a class."""
    import json
    from pathlib import Path
    from repro_torch.bench import bench_hybrid
    from repro_torch.core import autotune
    autotune.clear_cache()
    path = tmp_path / "hybrid.json"
    out = bench_hybrid.run(scale=8, n_sources=2, reps=1, device="cpu",
                           json_path=str(path), verbose=False)
    ref = json.loads((Path(__file__).resolve().parents[1]
                      / "BENCH_pr7.json").read_text())["hybrid"]
    _same_keys(out, ref)
    assert out["summary"]["all_verified"] is True
    for go in out["graphs"].values():
        assert go["speedup_hybrid_vs_pull"] > 0
        assert go["tuned"]["source"] in ("tuned", "cached")
    assert json.loads(path.read_text())["summary"] == out["summary"]
    autotune.clear_cache()


def test_bench_dist_cli_spawns_gloo_ranks(tmp_path):
    """``python -m repro_torch.bench.bench_dist --devices 2 --device
    cpu``: the 1-D part on 2 spawned gloo ranks and the ``dist2d`` block
    on 8, every part verified, the JSON written by rank 0."""
    out = tmp_path / "dist.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.bench_dist", "--devices",
         "2", "--device", "cpu", "--scale", "6", "--queries", "4",
         "--json", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(out.read_text())
    assert got["devices"] == 2 and got["device"] == "cpu"
    assert got["summary"]["all_verified"]
    assert got["dist2d"]["verified"]
    assert got["dist2d"]["comm"]["butterfly_shrink_4_to_8"] > 1.0
