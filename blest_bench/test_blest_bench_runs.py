"""CPU tests of whole runs of the harness on the port's CPU twins
(``device="cpu"``), at tiny sizes: the shape of the last line for each
traffic kind, a configuration, mix and metric added as files and found by
name, configurations that the tests have never seen (one of each generator
family) taken at their family's CPU size, and ``correct`` coming out false
when the timed path is broken underneath.  The runs happen in one fresh process (``tiny.main``), so the
import guard sees only what a run loads; whether a card is present is
decided inside a test."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from blest_bench import tiny

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 11
NEW_METRIC = '''"""Roots answered a second over the window (a throwaway metric)."""


def read(rec):
    w = rec["window"]
    return (w["attempted"] - w["failed"]) / w["wall_s"]
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _add_throwaway(root: Path) -> None:
    """A configuration, a mix, a metric and a cell, as new files and entries."""
    b = root / "blest_bench"
    cfg = json.loads((b / "configs" / "tiny_rgg_n_2_20.json").read_text())
    cfg["name"] = "rgg_small"
    cfg["generator"]["params"]["scale"] = 5
    (b / "configs" / "rgg_small.json").write_text(json.dumps(cfg))
    (b / "mixes" / "wave4.json").write_text(json.dumps(
        {"kind": "wave", "roots_per_batch": 4, "slots": 4}))
    (b / "metrics" / "roots_per_s.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rgg_small", "source": "a test",
                             "file": "blest_bench/configs/rgg_small.json",
                             "reduced": ["scale"], "why": "a test"})
    bench["workloads"].append({"name": "rgg_small.wave4", "config": "rgg_small",
                               "traffic": "wave4", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "roots_per_s", "unit": "roots/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["rgg_small.wave4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


#: configurations no test names elsewhere, one of each generator family,
#: each from a committed one at another scale: ``(from, name, scale)``
UNSEEN = [("graph500_s17", "graph500_s20", 20), ("rgg_n_2_20", "rgg_n_2_19", 19)]


def unseen_source(tmp: Path) -> Path:
    """A source root: the committed benchmark, and the :data:`UNSEEN`
    configurations given only as new files under ``configs/`` and new
    entries (a configuration and a ``wave64`` cell) in ``BENCHMARK.json``."""
    shutil.copytree(tiny.BENCH_DIR, tmp / "blest_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    configs = tmp / "blest_bench" / "configs"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for base, name, scale in UNSEEN:
        cfg = json.loads((configs / f"{base}.json").read_text())
        cfg["name"] = name
        cfg["generator"]["params"]["scale"] = scale
        (configs / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"blest_bench/configs/{name}.json",
                                 "reduced": [], "why": "a test"})
        bench["workloads"].append({"name": f"{name}.wave64", "config": name,
                                   "traffic": "wave64", "chips": 1,
                                   "why": "a test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    copied = _digests(root / "blest_bench")
    _add_throwaway(root)
    unseen = tiny.make_root(tmp_path_factory.mktemp("unseen"),
                            src=unseen_source(tmp_path_factory.mktemp("src")))
    base = {"root": str(root), "seed": SEED, "seconds": 0.2}
    jobs = [dict(base, workload=f"{name}.wave64", root=str(unseen))
            for _, name, _ in UNSEEN]
    jobs += [dict(base, workload="graph500_s17.wave64"),
            # whole calls after the traced one, for the rest's readers
            dict(base, workload="rgg_n_2_20.wave64", trace=1, seconds=3.0),
            dict(base, workload="rgg_n_2_20.wave64"),
            dict(base, workload="graph500_s17.single"),
            dict(base, workload="rgg_small.wave4")]
    jobs += [dict(base, workload=w, fault=f) for f in sorted(tiny.FAULTS)
             for w in ("graph500_s17.wave64", "rgg_n_2_20.wave64")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", "from blest_bench import tiny; tiny.main()",
         json.dumps(jobs)], capture_output=True, text=True, env=env,
        timeout=300, cwd=str(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    return {"root": root, "copied": copied, "unseen": unseen,
            "rows": {(r["job"]["workload"], r["job"].get("trace", 0),
                      r["job"].get("fault")): r for r in rows}}


def _result(runs, workload, trace=0, fault=None) -> dict:
    row = runs["rows"][(workload, trace, fault)]
    assert row["rc"] == 0 and row["result"] is not None, row
    return row["result"]


def _line_shape(res: dict) -> None:
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


@pytest.mark.parametrize("workload", ["graph500_s17.wave64", "rgg_n_2_20.wave64"])
def test_wave_cell_reports_its_end_to_end_metrics(runs, workload):
    res = _result(runs, workload)
    _line_shape(res)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"gteps", "setup_s"}
    assert res["checks"]["wrong_vertices"] == {"value": 0, "limit": 0}


def test_traced_run_reports_per_layer_metrics(runs):
    res = _result(runs, "rgg_n_2_20.wave64", trace=1)
    _line_shape(res)
    assert res["correct"]
    # the CPU twins leave no device trace and load no kernel library: only
    # host, span and counter metrics
    assert set(res["metrics"]) == {
        "prepare_s", "wave_level_ms", "syncs_per_level", "prepare_order_s",
        "prepare_bvss_s", "prepare_device_s", "wave_host_ms", "copy_wait_ms",
        "queue_fill.wave"}
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["prepare_order_s"] + m["prepare_bvss_s"] + m["prepare_device_s"] \
        <= m["prepare_s"]
    assert 0 < m["queue_fill.wave"] <= 1
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # one wave.copy_wait span for each host copy the engine counted, in the
    # traced slice and in the rest of the window
    for part in ("slice", "rest"):
        assert res["spans"][part]["wave.copy_wait"]["n"] == \
            res["counters"][part]["host_syncs"] > 0, part


def test_single_kind_serves_one_root_a_call(runs):
    res = _result(runs, "graph500_s17.single")
    _line_shape(res)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"gteps", "setup_s"}


def test_new_config_mix_and_metric_are_found_by_name(runs):
    res = _result(runs, "rgg_small.wave4")
    _line_shape(res)
    assert res["correct"] and res["attempted"] % 4 == 0
    assert res["metrics"]["roots_per_s"]["unit"] == "roots/s"
    # the committed files were copied and nothing of them was edited
    now = _digests(runs["root"] / "blest_bench")
    assert {k: now[k] for k in runs["copied"]} == runs["copied"]
    assert _digests(tiny.BENCH_DIR) == {
        k: v for k, v in runs["copied"].items()
        if not k.startswith("configs/tiny_")}


@pytest.mark.parametrize("base,name,scale", UNSEEN)
def test_unseen_configuration_runs_at_its_family_size(runs, base, name, scale):
    """A configuration given only as a file and entries is cut to its
    family's CPU size, as the committed one of that family is, and runs."""
    b = runs["unseen"] / "blest_bench" / "configs"
    new = json.loads((b / f"tiny_{name}.json").read_text())
    old = json.loads((b / f"tiny_{base}.json").read_text())
    assert new["generator"] == old["generator"]
    res = _result(runs, f"{name}.wave64")
    _line_shape(res)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"gteps", "setup_s"}


@pytest.mark.parametrize("fault", sorted(tiny.FAULTS))
@pytest.mark.parametrize("workload", ["graph500_s17.wave64", "rgg_n_2_20.wave64"])
def test_broken_timed_path_is_not_correct(runs, workload, fault):
    res = _result(runs, workload, fault=fault)
    assert res["correct"] is False
    assert res["checks"]["wrong_vertices"]["value"] > 0 or \
        res["checks"]["failed_roots"]["value"] > 0


def test_command_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    proc = subprocess.run(
        [sys.executable, "blest_bench/run.py", "--workload",
         "rgg_n_2_20.wave64", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=str(REPO),
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr
