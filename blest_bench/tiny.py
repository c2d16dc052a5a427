"""Tiny copies of the benchmark, and runs of them on the CPU, for its tests.

:func:`make_root` copies the committed benchmark verbatim into a temporary
root and adds, as new files, the configurations at CPU sizes and a
``BENCHMARK.json`` that names them: nothing that is there is edited.

:func:`main` runs a list of jobs through ``run.main`` on the port's CPU
twins, in a fresh process so that the import guard sees only what a run
loads, each job optionally with the timed path broken underneath
(:data:`FAULTS`); it prints one JSON line a job.

    python -c "from blest_bench import tiny; tiny.main()" '<jobs as JSON>'
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
BENCH_DIR = REPO / "blest_bench"


#: cells the tests add to the copy, by data alone: the Graph 500
#: configuration that waits for a later benchmark PR, under both kinds
#: (each only where ``BENCHMARK.json`` does not name it already)
GRAPH500 = {"name": "graph500_s17", "source": "Graph 500 Benchmark 1",
            "file": "blest_bench/configs/graph500_s17.json",
            "reduced": ["scale"], "why": "the social regime"}
EXTRA_CELLS = [{"name": f"graph500_s17.{t}", "config": "graph500_s17",
                "traffic": t, "chips": 1, "why": "a test"}
               for t in ("wave64", "single")]


def make_root(tmp: Path, src: Path = REPO) -> Path:
    """A root with the benchmark's files of ``src`` copied verbatim, every
    configuration at its family's CPU size (the ``TINY`` parameters of
    ``graphs/<family>.py``) as a new file, and the Graph 500 cells that
    ``BENCHMARK.json`` lacks."""
    from blest_bench import inputs
    shutil.copytree(src / "blest_bench", tmp / "blest_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    if all(c["name"] != GRAPH500["name"] for c in bench["configs"]):
        bench["configs"].append(dict(GRAPH500))
    cells = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [dict(w) for w in EXTRA_CELLS if w["name"] not in cells]
    for c in bench["configs"]:
        cfg = json.loads((tmp / c["file"]).read_text())
        family = cfg["generator"]["family"]
        cfg["generator"]["params"].update(inputs.load_module(
            tmp / "blest_bench" / "graphs" / f"{family}.py",
            inputs.module_name("graph", family)).TINY)
        c["file"] = f"blest_bench/configs/tiny_{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def _engine_patch(change):
    """Patch the wave pool that ``GraphSession`` builds with ``change(eng)``."""
    from repro_torch.serve import graph_session
    real = graph_session.make_ms_engine
    return mock.patch.object(graph_session, "make_ms_engine",
                             lambda *a, **k: change(real(*a, **k)))


def _stale():
    """A level step that returns its state unchanged, every column done."""
    import numpy as np
    return _engine_patch(lambda eng: dataclasses.replace(
        eng, level_step=lambda st: (st, np.zeros(eng.n_slots, dtype=bool))))


def _half():
    """Half of each batch served; the other half answered from it."""
    from repro_torch.serve.graph_session import GraphSession
    real = GraphSession.levels_batch

    def levels_batch(self, sources, **kw):
        half = max(1, len(sources) // 2)
        got = real(self, list(sources)[:half], **kw)
        return got + [got[i % half].copy() for i in range(len(sources) - half)]

    return mock.patch.object(GraphSession, "levels_batch", levels_batch)


def _altered():
    """Every answer altered where the engine produces it: level 1 reads 2."""
    def levels_of(real):
        def read(st, slot):
            x = real(st, slot).clone()
            x[x == 1] = 2
            return x
        return read

    return _engine_patch(lambda eng: dataclasses.replace(
        eng, levels_of=levels_of(eng.levels_of)))


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


def run_job(job: dict) -> dict:
    from blest_bench import run
    out, err = io.StringIO(), io.StringIO()
    fault = FAULTS[job["fault"]]() if job.get("fault") else \
        contextlib.nullcontext()
    run.TRACE_SLICE_S = 0.0             # the traced slice: one call
    with fault:
        rc = run.main(["--workload", job["workload"], "--seed", str(job["seed"]),
                       "--seconds", str(job["seconds"]),
                       "--trace", str(job.get("trace", 0))],
                      root=Path(job["root"]), device="cpu",
                      t_start=time.perf_counter(), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return {"job": job, "rc": rc,
            "result": json.loads(lines[-1]) if lines else None,
            "stderr_tail": err.getvalue().splitlines()[-3:]}


def main() -> None:
    import torch
    torch.set_num_threads(1)
    for job in json.loads(sys.argv[1]):
        print(json.dumps(run_job(job)), flush=True)
