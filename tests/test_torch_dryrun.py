"""The port's dry run (``repro_torch.launch.dryrun``, the cells of
``repro_torch.configs.families``, ``bench/roofline.py``, ``bench/perf_iter.py``)
on fake process groups.

The reference's own dry-run test (``test_dryrun_small_mesh_cells``) fails
in the reference, so it gives no numbers to match: these cases hold the
port to hand counts instead.

* The counter sees this rank's local ops: a matmul sharded four ways
  counts a quarter of the single-device FLOPs (``FlopCounterMode`` on
  the plain matmul).
* The reference's three small cells (``fm/train_batch``,
  ``gin-tu/full_graph_sm``, ``egnn/molecule``) build and trace on a fake
  (2, 2, 2) mesh.
* A purely data-parallel cell on a fake (4,) ``"data"`` mesh all-reduces
  exactly its gradient bytes (one all-reduce a leaf), and its wire bytes
  are twice that; its memory record is the state and batch counted by
  hand.
* The probe extrapolation (2 and 4 layers, linear; and the (layers x
  accum) bilinear grid) of 6-layer LM smoke configs equals the direct
  trace within 1e-6 relative.
* ``python -m repro_torch.launch.dryrun --all --mesh single --small``
  ends with 0 errors in a child process, and the roofline report reads
  its artifacts.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.bench import perf_iter, roofline
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMShape
from repro_torch.configs.families import build_cell, gnn_init, lm_cell
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import transformer as T
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_counter_counts_the_local_matmul():
    M, K, N = 64, 256, 512
    with FlopCounterMode(display=False) as fc:
        torch.randn(M, K) @ torch.randn(K, N)
    single = fc.get_total_flops()
    with fake_mesh((1, 4), ("data", "model")) as mesh, FakeTensorMode():
        x = DTensor.from_local(torch.empty(M, K), mesh,
                               (Replicate(), Replicate()), run_check=False)
        w = DTensor.from_local(torch.empty(K, N // 4), mesh,
                               (Replicate(), Shard(1)), run_check=False)
        with D.CostCounter() as counter:
            y = x @ w
        assert y.placements == (Replicate(), Shard(1))
    assert counter.flops * 4 == single == 2 * M * K * N
    # bytes: the local operands and output, float32
    assert counter.hbm_bytes == 4 * (M * K + K * N // 4 + M * N // 4)
    assert counter.collectives["count"] == 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch_id,shape", [("fm", "train_batch"),
                                           ("gin-tu", "full_graph_sm"),
                                           ("egnn", "molecule")])
def test_reference_small_cells_trace_on_a_fake_multi_pod_mesh(
        tmp_path, arch_id, shape):
    rec = D.run_cell(arch_id, shape, "multi", small=True,
                     out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh_shape"] == [2, 2, 2]
    assert rec["hbm_bytes_per_device"] > 0
    assert rec["collectives"]["count"] > 0
    assert rec["memory"]["total_bytes_per_device"] > 0
    assert rec["dominant"] in rec["roofline"]
    saved = json.loads((tmp_path / "multi" /
                        f"{arch_id}__{shape}.json").read_text())
    assert saved["status"] == "ok"
    assert not dist.is_initialized()


def test_data_parallel_cell_all_reduces_its_gradient_bytes():
    arch = get_arch("gin-tu")
    leaves = T.reference_leaves(gnn_init(arch, device="meta"))
    grad_bytes = sum(v.numel() * 4 for v in leaves.values())
    with fake_mesh((4,), ("data",)) as mesh:
        cell = build_cell(arch, "molecule", mesh, FakeTensorMode())
        _, _, coll = D._trace_metrics(cell)
        mem = D._memory(cell)
    assert coll["all-reduce"] == grad_bytes
    assert coll["count"] == len(leaves)
    assert coll["wire_bytes"] == 2 * grad_bytes
    assert coll["all-gather"] == coll["reduce-scatter"] == \
        coll["all-to-all"] == coll["collective-permute"] == 0
    # params, m and v whole on every rank; a quarter of the 128 graphs
    shape = arch.shapes["molecule"]
    g, n1, e = shape.batch // 4, shape.max_nodes + 1, shape.max_edges
    batch = g * (2 * e * 4 + n1 * arch.model_cfg.d_in * 2 + 2 + n1 * 4)
    state = 3 * grad_bytes + 4 + 4         # two int32 step counts
    assert mem["argument_size_in_bytes"] == state + batch
    assert mem["alias_size_in_bytes"] == state
    assert mem["total_bytes_per_device"] == state + batch + 12


def _six_layers(arch_id: str, **arch_kw):
    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.smoke_cfg, n_layers=6 +
                              arch.smoke_cfg.n_dense_layers)
    return dataclasses.replace(arch, model_cfg=cfg, **arch_kw)


@pytest.mark.parametrize("arch_id,accum", [("qwen3-0.6b", 1),
                                           ("olmoe-1b-7b", 4)])
def test_probe_extrapolation_equals_direct_trace(arch_id, accum):
    arch = _six_layers(arch_id, accum_steps=accum)
    shape = LMShape("train", 512, 16)
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        cell = lm_cell(arch, shape, mesh, FakeTensorMode())
        assert cell.probe[0] == ("bilinear" if accum > 2 else "linear")
        flops, hbm, coll = D._probe_costs(cell)
        direct = D._trace_metrics(cell)
    assert flops == pytest.approx(direct[0], rel=1e-6)
    assert hbm == pytest.approx(direct[1], rel=1e-6)
    for k, v in direct[2].items():
        assert coll[k] == pytest.approx(v, rel=1e-6, abs=1), k
    assert direct[2]["count"] > 0


def test_cli_all_small_single_ends_without_errors(tmp_path):
    out = tmp_path / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "single", "--small", "--jobs", "4", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.endswith(" 0 errors"), last
    n_ok = int(last.split()[1])
    recs = roofline.load(str(out))
    assert sum(r["status"] == "ok" for r in recs) == n_ok > 30
    table = roofline.render(recs)
    assert table.count("\n") == len(recs) + 1
    # a 61-layer cell went through its probes
    ds = next(r for r in recs if r["arch"] == "deepseek-v3-671b"
              and r["shape"] == "train_4k")
    assert ds["cost_source"].startswith("probe-extrapolated")
    # MODEL/traced FLOPs of the dense LM train cells lie between 0.1 and 1
    for r in recs:
        if r["status"] == "ok" and r["shape"] == "train_4k" and \
                r["arch"] in ("qwen3-0.6b", "h2o-danube-1.8b"):
            arch = get_arch(r["arch"])
            mf = roofline.model_flops(arch, arch.shapes["train_4k"])
            ratio = mf / (r["flops_per_device"] * math.prod(r["mesh_shape"]))
            assert 0.1 < ratio < 1.0, (r["arch"], ratio)


def test_perf_iter_variant_against_its_baseline(tmp_path, capsys):
    base = tmp_path / "base"
    D.run_cell("fm", "serve_p99", "single", out_dir=str(base))
    rec = perf_iter.run_variant("fm/serve_p99", "full_shard_table",
                                "single", out_dir=str(tmp_path / "perf"),
                                base_dir=str(base))
    assert rec["status"] == "ok"
    assert "vs baseline" in capsys.readouterr().out


def test_failed_cell_records_its_error_and_leaves_no_group(tmp_path):
    arch = dataclasses.replace(get_arch("fm"), family="nope")
    rec = D.run_cell("fm", "train_batch", "single", small=True,
                     out_dir=str(tmp_path), arch_obj=arch)
    assert rec["status"] == "error" and "nope" in rec["error"]
    assert not dist.is_initialized()
    skipped = D.run_cell("qwen3-0.6b", "long_500k", "single", small=True,
                         out_dir=str(tmp_path))
    assert skipped["status"] == "skipped"
