"""The PyTorch port stands alone and never falls back.

* ``repro_torch`` and ``chip_smoke.py`` import neither ``jax``, nor the JAX
  package ``repro``, nor its ``benchmarks``: a fresh interpreter that
  imports the port and runs a CPU BFS, the launcher and the bench scripts
  has none of them in ``sys.modules``, and no source file names them.
* Entry points run on the card unless the caller asks for the CPU: without
  a card, ``prepare`` raises instead of quietly running on the CPU.
* A CUDA operand goes through its kernel or the call raises: a kernel that
  cannot be built is never answered by its twin.
"""
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.errors import ConfigError, KernelBuildError
from repro_torch.kernels import _build, ops

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro|benchmarks)\b(?!_)|"
                       r"from\s+(jax|repro|benchmarks)\b(?!_))", re.MULTILINE)


def test_port_process_never_loads_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "g = repro_torch.generators.grid2d(9, 7)\n"
        "p = repro_torch.prepare(g, device='cpu')\n"
        "lv = p.levels(0)\n"
        "assert (lv == repro_torch.reference_bfs(g, 0)).all()\n"
        "sess = repro_torch.GraphSession(\n"
        "    g, max_batch=2,\n"
        "    options=repro_torch.PrepareOptions(device='cpu'))\n"
        "for s, lv in zip((0, 5, 9), sess.levels_batch([0, 5, 9])):\n"
        "    assert (lv == repro_torch.reference_bfs(g, s)).all()\n"
        "assert len(sess.components()) == g.n\n"
        "import numpy as np\n"
        "wsess = repro_torch.GraphSession(\n"
        "    g, max_batch=2, options=repro_torch.PrepareOptions(\n"
        "        device='cpu', weights=np.full(g.m, 0.5, np.float32)))\n"
        "assert wsess.betweenness_batch([0, 5, 9]).shape == (g.n,)\n"
        "assert wsess.sssp_batch([0, 5])[0, 0] == 0.0\n"
        "assert abs(wsess.pagerank().sum() - 1.0) < 1e-5\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_launcher_and_benches_never_load_jax_reference_or_benchmarks():
    code = (
        "import sys\n"
        "from repro_torch.launch import bfs\n"
        "from repro_torch.bench import bench_service, kernel_bench\n"
        "from repro_torch.bench import table2_bfs\n"
        "bfs.main(['--graph', 'road', '--scale', '6', '--engine', 'dirop',\n"
        "          '--sources', '2', '--device', 'cpu'])\n"
        "kernel_bench.run('cpu', n_vertices=100, verbose=False)\n"
        "from repro_torch.launch import analytics\n"
        "from repro_torch.bench import (bench_analytics, bench_scale,\n"
        "                               fig3_window, table1a_compression,\n"
        "                               table1b_divergence, table4_footprint)\n"
        "analytics.main(['--graph', 'road', '--scale', '6', '--what',\n"
        "                'components,pagerank', '--device', 'cpu'])\n"
        "out = bench_scale.run(scales=(6,), verbose=False, device='cpu')\n"
        "assert out['summary']['all_verified']\n"
        "table4_footprint.run(6, verbose=False, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "VERIFIED vs oracle" in out.stdout, out.stdout
    assert "VERIFIED vs float64 power iteration" in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout


SCANNED = sorted(str(p.relative_to(ROOT))
                 for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                           ROOT / "chip_smoke.py"])


def test_scan_covers_the_wave_slice():
    """The scan below walks the whole package, the wave and float-channel
    slices included."""
    for module in ("core/multi_source.py", "kernels/mxu_pull.py",
                   "serve/graph_session.py", "analytics/components.py",
                   "analytics/eccentricity.py", "analytics/closeness.py",
                   "analytics/common.py", "analytics/betweenness.py",
                   "analytics/sssp.py", "analytics/pagerank.py",
                   "launch/bfs.py", "bench/common.py", "bench/table2_bfs.py",
                   "bench/bench_service.py", "bench/kernel_bench.py",
                   "launch/analytics.py", "bench/table1a_compression.py",
                   "bench/table1b_divergence.py", "bench/table4_footprint.py",
                   "bench/fig3_window.py", "bench/bench_scale.py",
                   "bench/bench_analytics.py"):
        assert f"src/repro_torch/{module}" in SCANNED, module


@pytest.mark.parametrize("path", SCANNED)
def test_no_source_imports_jax_or_reference(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), FORBIDDEN.findall(text)


def test_import_pattern_catches_what_it_must():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "import repro", "from repro.core import bfs",
                "  from repro import prepare", "import benchmarks",
                "from benchmarks.common import graph_suite"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import bfs",
               "# the port never imports jax"):
        assert not FORBIDDEN.search(ok), ok


def test_prepare_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = repro_torch.generators.path(10)
    with pytest.raises(ConfigError, match="no CUDA device"):
        repro_torch.prepare(g)
    with pytest.raises(ConfigError, match="no CUDA device"):
        repro_torch.prepare(g, device="cuda:0")
    assert repro_torch.prepare(g, device="cpu").device.type == "cpu"


def test_unbuildable_kernel_raises_instead_of_twin(monkeypatch, tmp_path):
    """Operands the dispatch sends to the kernel (CUDA tensors; simulated
    here) meet a compiler that fails: the call raises KernelBuildError and
    no twin answers."""
    # the Python interpreter as the compiler: it rejects nvcc's flags
    monkeypatch.setattr(_build, "nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(ops, "use_kernel", lambda *tensors: True)
    twin_calls = []
    for mod, twin in (("bvss_pull", "bvss_pull_ref"),
                      ("frontier_finalize", "finalize_pack_ref")):
        monkeypatch.setattr(
            importlib.import_module(f"repro_torch.kernels.{mod}"), twin,
            lambda *a, **k: twin_calls.append(a))
    masks = torch.zeros((4, 32), dtype=torch.int32)
    fb = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        repro_torch.kernels.bvss_pull(masks, fb, sigma=8)
    with pytest.raises(KernelBuildError):
        repro_torch.kernels.finalize_pack_sweep(
            torch.zeros(64, dtype=torch.int32), 1, sigma=8, n_fwords=2,
            n_sets=8)
    assert twin_calls == []


def test_unbuildable_bench_kernels_raise_instead_of_twin(monkeypatch,
                                                         tmp_path):
    """The same for the dense multi-source and kernel-bench kernels."""
    monkeypatch.setattr(_build, "nvcc", lambda: sys.executable)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(ops, "use_kernel", lambda *tensors: True)
    twin_calls = []
    for mod, twin in (("mxu_pull", "bit_spmm_ref"),
                      ("frontier_finalize", "finalize_sweep_ref")):
        monkeypatch.setattr(
            importlib.import_module(f"repro_torch.kernels.{mod}"), twin,
            lambda *a, **k: twin_calls.append(a))
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        repro_torch.kernels.bit_spmm(torch.zeros((4, 2), dtype=torch.int32),
                                     torch.zeros((64, 8), dtype=torch.int8))
    with pytest.raises(KernelBuildError):
        repro_torch.kernels.finalize_sweep(
            torch.zeros(64, dtype=torch.uint8),
            torch.zeros(64, dtype=torch.int32), 1)
    assert twin_calls == []


def test_compiler_that_cannot_start_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(KernelBuildError, match="cannot run"):
        _build.build_all()


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        _build.nvcc()
