"""One run of one cell of the benchmark of the PyTorch and CUDA port.

    python3 blest_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.  The
run makes the cell's graph (one fixed instance, from its configuration)
and its roots (from the seed), builds the port's
``GraphSession`` on the card, warms it with one call of the cell's traffic,
then measures for ``--seconds``: the window opens with the first call sent
and closes when the last call sent before ``--seconds`` had passed returns.
Afterwards it checks a sample of the window's answers, drawn from the seed,
against the plain NumPy reference, and prints one JSON line.  With
``--trace 1`` it turns the port's spans on before ``GraphSession(...)``,
profiles the window's first whole calls (at least ``TRACE_SLICE_S`` of
them), keeps the spans of set-up, of that traced slice and of the rest of
the window apart, and reports the per-layer metrics instead of the
end-to-end ones.

Everything a cell names is found by name: ``BENCHMARK.json`` gives the cell's
configuration and traffic, the configuration file its generator
(``graphs/<family>.py``), ``mixes/<traffic>.json`` its traffic kind
(``traffic/<kind>.py``), and each metric is read by ``metrics/<name>.py``.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()     # set-up is counted from here

import argparse               # noqa: E402
import gc                     # noqa: E402
import json                   # noqa: E402
import os                     # noqa: E402
import sys                    # noqa: E402
import threading              # noqa: E402
import traceback              # noqa: E402
from pathlib import Path      # noqa: E402

import numpy as np            # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = "blest_bench"
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the traced slice: the window's first whole calls until this much has passed
TRACE_SLICE_S = 3.0
SPAN = "blest_bench.traced_slice"
#: the wave engine's counters (``GraphSession.counters()["wave"]``)
COUNTERS = ("pull_levels", "push_levels", "host_syncs", "pull_width",
            "pull_live")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among the loaded modules (or ``names``),
    each compared whole: ``repro_torch`` is the port, not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Kernel caches the libraries may keep, at fixed paths in the checkout
    (the port's own nvcc builds go to ``build/repro_torch_kernels``)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(root / "build" / "torch_kernels")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Reservoir:
    """A uniform sample of ``size`` answers, drawn from the seed."""

    def __init__(self, size: int, rng):
        self.size, self.rng = size, rng
        self.seen, self.items = 0, []

    def offer(self, root, answer) -> None:
        if len(self.items) < self.size:
            self.items.append((int(root), answer))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = (int(root), answer)
        self.seen += 1


def call(kind, session, mix, roots, n: int, offer, err) -> tuple:
    """One closed-loop call: ``(sent, done, roots, failed, answered roots)``."""
    rs = roots.batch(kind.roots_per_call(mix))
    sent = time.perf_counter()
    try:
        answers = list(kind.serve(session, rs))
    except Exception:          # the run goes on: the call's roots count failed
        traceback.print_exc(file=err)
        answers = []
    done = time.perf_counter()
    answered = []
    for r, a in zip(rs, answers):
        if a is not None and np.shape(a) == (n,):
            answered.append(int(r))
            offer(r, a)
    return sent, done, len(rs), len(rs) - len(answered), answered


def main(argv=None, *, root: Path = ROOT, device: str = "cuda",
         t_start: float | None = None, out=None, err=None) -> int:
    out = out or sys.stdout
    err = err or sys.stderr
    t_start = _T0 if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    seed = args.seed % 2**64

    import torch

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=err)
        return 2
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=err)
        return 2
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / BENCH / "mixes" / f"{cell['traffic']}.json").read_text())

    from blest_bench import components, inputs, reference, trace
    from repro_torch.core.policy import PrepareOptions
    from repro_torch.graphs.csr import from_edges
    from repro_torch.serve.graph_session import GraphSession

    bench_dir = root / BENCH
    kind = inputs.load_module(bench_dir / "traffic" / f"{mix['kind']}.py",
                              inputs.module_name("traffic", mix["kind"]))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    t_gen = time.perf_counter()
    edges = inputs.make_graph(config, bench_dir)
    g = from_edges(edges.n, *edges.directed(), dedup=False)
    tracing = None
    if args.trace:                     # the port's spans, set-up's kept apart
        from repro_torch import tracing
        tracing.enable()
    t_prep = time.perf_counter()
    session = GraphSession(
        g, max_batch=kind.slots(mix),
        options=PrepareOptions(device=None if device == "cuda" else "cpu"))
    sync()
    prepare_s = time.perf_counter() - t_prep
    setup_spans = tracing.drain() if tracing else []
    print(f"[{args.workload}] n={edges.n} undirected_m={edges.m} "
          f"ordering={session.ordering} engine={session.engine_name} "
          f"slots={session.max_batch} imports_s={t_gen - t_start:.3f} "
          f"graph_s={t_prep - t_gen:.3f} prepare_s={prepare_s:.3f}", file=err)

    sample = Reservoir(int(config["reference_sample"]),
                       np.random.default_rng([seed, 2]))
    t_warm = time.perf_counter()
    call(kind, session, mix, inputs.Roots(edges, seed, stream=1), edges.n,
         lambda r, a: None, err)                             # the warm call
    sync()
    print(f"[{args.workload}] warm_s={time.perf_counter() - t_warm:.3f}",
          file=err)
    if tracing:
        setup_spans += tracing.drain()
    gc.collect()

    def snapshot():
        c = session.counters()
        return c["wave"], c["launches"]

    roots = inputs.Roots(edges, seed, stream=0)
    c0, l0 = snapshot()

    # with --trace 1 the profiler covers the window's first whole calls,
    # until TRACE_SLICE_S has passed; the counters cover the whole window,
    # and the spans and counters of the rest are also kept apart, free of
    # the profiler's cost
    prof = span = None
    slice_spans = []
    slice_ns = []                  # the slice's start and end, span clock
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else []))
        span = record_function(SPAN)
        prof.start()
        slice_ns.append(time.perf_counter_ns())
        span.__enter__()
    sliced = None

    def end_slice():
        nonlocal span, sliced
        sync()
        slice_ns.append(time.perf_counter_ns())
        span.__exit__(None, None, None)
        prof.stop()
        span, sliced = None, snapshot()
        if tracing:
            slice_spans.extend(tracing.drain())

    batches, answered = [], []
    setup_s = None
    while not batches or time.perf_counter() - batches[0][0] < args.seconds:
        sent, done, k, bad, ok = call(kind, session, mix, roots, edges.n,
                                      sample.offer, err)
        if setup_s is None:
            setup_s = sent - t_start
        batches.append((sent, done, k, bad))
        answered += ok
        if span is not None and done - batches[0][0] >= TRACE_SLICE_S:
            end_slice()
    if span is not None:
        end_slice()
    c1, l1 = snapshot()
    spans = None
    if tracing:
        rest_spans = tracing.drain()
        tracing.disable()
        spans = {"setup": setup_spans, "slice": slice_spans, "rest": rest_spans}
    window = {"wall_s": batches[-1][1] - batches[0][0], "batches": batches,
              "attempted": sum(b[2] for b in batches),
              "failed": sum(b[3] for b in batches)}
    counters = {k: c1[k] - c0[k] for k in COUNTERS}
    launches = {k: l1[k] - l0[k] for k in l1}

    trace_rec = parts = None
    if prof is not None:
        c2, l2 = sliced
        parts = {"slice": {k: c2[k] - c0[k] for k in COUNTERS},
                 "rest": {k: c1[k] - c2[k] for k in COUNTERS}}
        trace_rec = trace.summarize(prof, SPAN)
        trace_rec["levels"] = (c2["pull_levels"] + c2["push_levels"]
                               - c0["pull_levels"] - c0["push_levels"])
        trace_rec["hand_launches"] = sum(l2[k] - l0[k] for k in l2)
        gaps = trace.on_span_clock(trace_rec.pop("gaps_us"),
                                   trace_rec["slice_us"], tuple(slice_ns))
        here = threading.get_ident()
        trace_rec["idle_under"] = trace.idle_under(
            gaps, [s for s in spans["slice"] if s.thread == here])
        del prof

    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell["chips"]),
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace_rec is not None:
        dev["busy_s"] = trace_rec["busy_s"]
        dev["window_s"] = trace_rec["window_s"]
    levels = counters["pull_levels"] + counters["push_levels"]
    print(f"[{args.workload}] window_s={window['wall_s']:.3f} "
          f"calls={len(batches)} roots={window['attempted']} "
          f"failed={window['failed']} levels={levels} "
          f"host_syncs={counters['host_syncs']} launches={launches}",
          file=err)
    span_s = None
    if spans is not None:
        span_s = {k: trace.span_totals(v) for k, v in spans.items()}
        for k, tot in span_s.items():
            print(f"[{args.workload}] {k} spans: " + " ".join(
                f"{name}={v['n']}/{v['s']:.6f}s" for name, v in sorted(tot.items())),
                file=err)
    if trace_rec is not None:
        print(f"[{args.workload}] slice idle by span: " + " ".join(
            f"{p or '-'}={s:.6f}s" for p, s in sorted(
                trace_rec["idle_under"].items(), key=lambda kv: -kv[1])),
            file=err)
    del session, g
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the yardstick, after the window: traversed edges and the reference
    comp = components.edges_of_component(edges.n, edges.a, edges.b)
    t_ref = time.perf_counter()
    indptr, indices = reference.csr(edges.n, edges.a, edges.b)
    wrong = max((reference.wrong_vertices(
        a, reference.bfs_levels(indptr, indices, r)) for r, a in sample.items),
        default=0)
    print(f"[{args.workload}] reference over {len(sample.items)} of "
          f"{sample.seen} answers: {time.perf_counter() - t_ref:.3f} s",
          file=err)
    rec = {"setup_s": setup_s, "prepare_s": prepare_s, "window": window,
           "traversed_edges": int(comp[np.asarray(answered, dtype=np.int64)].sum()),
           "counters": counters, "trace": trace_rec, "spans": span_s,
           "rest_counters": parts and parts["rest"]}

    metrics = {}
    group = bench["per_layer"] if args.trace else bench["end_to_end"]
    for m in group:
        if not applies(m, args.workload):
            continue
        reader = inputs.load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                    inputs.module_name("metric", m["name"]))
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks = {
        "failed_roots": {"value": window["failed"], "limit": 0},
        "wrong_vertices": {"value": wrong, "limit": 0},
        "checked_answers": {"value": len(sample.items), "at_least": 1},
    }
    correct = (window["failed"] == 0 and wrong == 0 and len(sample.items) >= 1)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=err)
        return 3
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace_rec is not None:
        result["breakdown"] = trace_rec["breakdown"]
        result["spans"] = span_s        # the counts and seconds behind them
        result["counters"] = parts
    result["checks"] = checks
    for name, c in checks.items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        print(f"check {name} {c['value']} {bound}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    # the package's own directory off the path: its module names (trace,
    # inputs) must not shadow the standard library's
    here = Path(__file__).resolve().parent
    sys.path = [str(ROOT), str(ROOT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != here]
    cache_env(ROOT)
    sys.exit(main())
