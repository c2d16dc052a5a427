#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build and identify: the card's name and power limit (nvidia-smi), the
   torch and CUDA versions, and the time ``nvcc`` takes to build every
   kernel under ``src/repro_torch/kernels/csrc``;
2. kernels against their PyTorch twins on the card: random inputs from a
   seed, at the main-path shapes and at ragged sizes, for sigma in
   {1, 4, 8, 32}, words with bit 31 set included; outputs must be equal;
   each kernel and twin is timed with CUDA events (median);
3. main path, road regime: ``repro_torch.prepare(grid2d(2048, 2048))``
   with default options (RCM, eager ``blest``, direction "auto" with push
   engaged) and ``.levels(src)`` for 4 sources, each equal to the host
   oracle ``reference_bfs``; every kernel's launch count must grow;
4. the lazy engine (``blest_lazy``) on the same prepared graph, against the
   oracle (the lazy mode of ``finalize_pack_sweep``);
5. main path, social regime: ``prepare(rmat(18))`` (Jaccard ordering),
   checked the same way.

Then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Bounds use the H100 SXM's published
HBM3 rate, 3.35 TB/s (NVIDIA data sheet).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
L2_BYTES = 50 * 2 ** 20          # H100 L2: timed inputs rotate past it
INF = (1 << 31) - 1
SIGMAS = (1, 4, 8, 32)
PROFILE_LEVELS = 1024            # levels of the grid BFS under the profiler


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def device_ms(torch, fn, inputs: list, reps: int = 20) -> float:
    """Median device time of one ``fn(*inp)`` call, in ms.

    ``inputs`` is a list of argument tuples whose total size exceeds the L2
    cache, cycled so every call reads cold inputs.  Each sample is a batch
    of calls queued behind a GPU sleep long enough to cover the host's
    enqueue time, so the events bracket back-to-back device work only."""
    for inp in inputs[:3]:
        fn(*inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(max(host_s, 1e-4) * 2e9 * 3)   # ~3x at <= 2 GHz
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def rotating(make, nbytes: int) -> list:
    """Independent input tuples from ``make(i)``: enough to exceed twice the
    L2 cache, at most 64 (a smaller input stays partly cached)."""
    return [make(i) for i in range(min(64, max(1, -(-2 * L2_BYTES // nbytes))))]


# ---------------------------------------------------------------------------
# phase 2: kernels against twins
# ---------------------------------------------------------------------------
def u32_words(rng, shape) -> np.ndarray:
    """Random uint32 words as int32, with some all-ones and bit-31-only
    words so the sign bit is always exercised."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[::7] = 0xFFFFFFFF
    flat[3::11] = 0x80000000
    return w.view(np.int32)


def max_abs_err(torch, got, want) -> int:
    """Largest |kernel - twin| over an output, as integers (uint32 words
    compared as unsigned values)."""
    a = got.to(torch.int64)
    b = want.to(torch.int64)
    if got.dtype == torch.int32:
        a, b = a & 0xFFFFFFFF, b & 0xFFFFFFFF
    return int((a - b).abs().max()) if a.numel() else 0


def check_equal(torch, name: str, got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name}: kernel gave {g.dtype} {tuple(g.shape)}, twin "
                 f"{w.dtype} {tuple(w.shape)}")
        err = max(err, max_abs_err(torch, g, w))
    if err:
        fail(f"{name}: kernel differs from its twin (max abs err {err})")
    return err


def phase_kernels(torch, rt) -> dict:
    from repro_torch.kernels import (bvss_pull, bvss_push,
                                     finalize_pack_sweep)
    from repro_torch.kernels.ref import (bvss_pull_ref, bvss_push_ref,
                                         finalize_pack_ref)
    rng = np.random.default_rng(SEED)
    cuda = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    # --- correctness sweep: main-path and ragged sizes, every sigma -------
    checked = 0
    for sigma in SIGMAS:
        for B in (1, 127, 1003, 524_288 if sigma == 8 else 4099):
            m = t(u32_words(rng, (B, 32)))
            fb = t(u32_words(rng, (B,)))
            check_equal(torch, f"bvss_pull sigma={sigma} B={B}",
                        bvss_pull(m, fb, sigma=sigma),
                        bvss_pull_ref(m, fb, sigma))
            bits = rng.integers(0, sigma, B).astype(np.int32)
            bits[::5] = sigma - 1
            bits = t(bits)
            check_equal(torch, f"bvss_push sigma={sigma} B={B}",
                        bvss_push(m, bits, sigma=sigma),
                        bvss_push_ref(m, bits, sigma))
            checked += 2
        for N in (1, 33, 1000, 4_194_304 - 5, 4_194_304):
            n_sets = -(-N // sigma)
            n_fwords = (n_sets * sigma + 31) // 32
            lvl = 7
            lv = rng.choice(np.array([INF, lvl, 3, 0], np.int32), N,
                            p=[0.5, 0.2, 0.2, 0.1])
            levels = t(lv)
            marks = t(rng.integers(0, 3, N).astype(np.uint8))
            kw = dict(sigma=sigma, n_fwords=n_fwords, n_sets=n_sets)
            check_equal(torch, f"finalize eager sigma={sigma} N={N}",
                        finalize_pack_sweep(levels, lvl, **kw),
                        finalize_pack_ref(levels, lvl, **kw))
            check_equal(torch, f"finalize lazy sigma={sigma} N={N}",
                        finalize_pack_sweep(levels, lvl, marks=marks, **kw),
                        finalize_pack_ref(levels, lvl, marks=marks, **kw))
            checked += 2
    torch.cuda.synchronize()

    # --- timing at the main-path shapes (grid2d(2048, 2048), sigma = 8) ---
    sigma = 8
    out = {}
    B = 524_288                     # full pull width of the grid's ladder
    pull_in = rotating(lambda i: (t(u32_words(rng, (B, 32))),
                                  t(u32_words(rng, (B,)))), B * 132)
    spw = 32 // sigma
    pull_bytes = B * 32 * 4 + B * 4 + B * spw * 32
    err = check_equal(torch, "bvss_pull timed", bvss_pull(*pull_in[0],
                                                          sigma=sigma),
                      bvss_pull_ref(*pull_in[0], sigma))
    out["bvss_pull"] = dict(
        shape={"B": B, "sigma": sigma}, max_abs_err=err,
        ms=device_ms(torch, lambda m, f: bvss_pull(m, f, sigma=sigma),
                     pull_in),
        plain_ms=device_ms(torch, lambda m, f: bvss_pull_ref(m, f, sigma),
                           pull_in),
        bound_ms=pull_bytes / HBM_BYTES_PER_S * 1e3)

    B = 128                         # push_cap * max_vss_per_set on the grid
    push_in = rotating(lambda i: (
        t(u32_words(rng, (B, 32))),
        t(rng.integers(0, sigma, B).astype(np.int32))), B * 132)
    push_bytes = B * 32 * 4 + B * 4 + B * spw * 32
    err = check_equal(torch, "bvss_push timed",
                      bvss_push(*push_in[0], sigma=sigma),
                      bvss_push_ref(*push_in[0], sigma))
    out["bvss_push"] = dict(
        shape={"B": B, "sigma": sigma}, max_abs_err=err,
        ms=device_ms(torch, lambda m, b: bvss_push(m, b, sigma=sigma),
                     push_in),
        plain_ms=device_ms(torch, lambda m, b: bvss_push_ref(m, b, sigma),
                           push_in),
        bound_ms=push_bytes / HBM_BYTES_PER_S * 1e3)

    N = 4_194_304
    n_sets, n_fwords = N // sigma, N // 32
    kw = dict(sigma=sigma, n_fwords=n_fwords, n_sets=n_sets)
    lvl = 7

    def fin_inputs(i):
        lv = rng.choice(np.array([INF, lvl, 3], np.int32), N,
                        p=[0.6, 0.1, 0.3])
        return t(lv), t(rng.integers(0, 2, N).astype(np.uint8))

    fin_in = rotating(fin_inputs, N * 5)
    eager_bytes = N * 4 + n_fwords * 4 + n_sets
    lazy_bytes = N * 4 + N + N * 4 + n_fwords * 4 + n_sets
    err = max(
        check_equal(torch, "finalize eager timed",
                    finalize_pack_sweep(fin_in[0][0], lvl, **kw),
                    finalize_pack_ref(fin_in[0][0], lvl, **kw)),
        check_equal(torch, "finalize lazy timed",
                    finalize_pack_sweep(fin_in[0][0], lvl,
                                        marks=fin_in[0][1], **kw),
                    finalize_pack_ref(fin_in[0][0], lvl,
                                      marks=fin_in[0][1], **kw)))
    out["finalize_pack_sweep"] = dict(
        shape={"N": N, "sigma": sigma, "mode": "eager"}, max_abs_err=err,
        ms=device_ms(torch, lambda lv, mk: finalize_pack_sweep(lv, lvl, **kw),
                     fin_in),
        plain_ms=device_ms(
            torch, lambda lv, mk: finalize_pack_ref(lv, lvl, **kw), fin_in),
        bound_ms=eager_bytes / HBM_BYTES_PER_S * 1e3,
        lazy_ms=device_ms(
            torch, lambda lv, mk: finalize_pack_sweep(lv, lvl, marks=mk, **kw),
            fin_in),
        lazy_plain_ms=device_ms(
            torch, lambda lv, mk: finalize_pack_ref(lv, lvl, marks=mk, **kw),
            fin_in),
        lazy_bound_ms=lazy_bytes / HBM_BYTES_PER_S * 1e3)
    emit({"phase": "kernels_vs_twins", "cases_equal": checked,
          "tolerance": "exact (max abs err 0)"})
    return out


# ---------------------------------------------------------------------------
# phases 3-5: BFS through the public entry points
# ---------------------------------------------------------------------------
def run_sources(torch, g, levels_fn, sources, oracle) -> list[dict]:
    """Run ``levels_fn(src)`` per source, hold it against the oracle, and
    return per-source timings."""
    rows = []
    for s in sources:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lv = levels_fn(s)                       # ends in a device-to-host copy
        dt = time.perf_counter() - t0
        want = oracle(g, s)
        if lv.shape != want.shape or lv.dtype != want.dtype:
            fail(f"levels from {s}: {lv.dtype} {lv.shape}, oracle "
                 f"{want.dtype} {want.shape}")
        if not np.array_equal(lv, want):
            bad = int(np.count_nonzero(lv != want))
            fail(f"levels from source {s} differ from the oracle at {bad} "
                 f"vertices")
        levels_run = int(want[want != INF].max()) + 1
        rows.append({"src": int(s), "bfs_ms": dt * 1e3,
                     "levels_run": levels_run,
                     # one device-to-host copy per level plus the start's
                     "host_syncs": levels_run + 1,
                     "gteps": g.m / dt / 1e9})
    return rows


def memo_oracle(rt):
    """``reference_bfs`` remembered per source (phases 3 and 4 share a graph)."""
    memo = {}

    def oracle(g, s):
        if s not in memo:
            memo[s] = rt.reference_bfs(g, s)
        return memo[s]

    return oracle


def profile_levels(torch, bfs, src: int, name: str, card: str,
                   levels: int | None) -> None:
    """Where one BFS's time goes on the card: ``torch.profiler`` over
    ``bfs(src)`` (cut to ``levels`` levels when given).  Prints the wall
    time, the device's busy time (the union of its kernel and copy
    intervals) and idle share, and the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bfs(src)                                    # warm: allocator, libraries
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bfs(src)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for a, b, kname in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        row = by_name.setdefault(kname, [0.0, 0])
        row[0] += b - a
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": f"profile_{name}", "levels_cap": levels,
          "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3 if spans else None,
          "device_idle_share": 1 - busy_us / wall_us if spans else None,
          "device_events": len(spans),
          "by_kernel": [{"name": k[:90], "device_ms": v[0] / 1e3,
                         "calls": v[1]} for k, v in top],
          "card": card})


def bfs_phase(torch, rt, name: str, g, sources, card: str, oracle) -> tuple:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    p = rt.prepare(g)
    prep_s = time.perf_counter() - t0
    reset_launch_counts()
    rows = run_sources(torch, g, p.levels, sources, oracle)
    counts = launch_counts()
    emit({"phase": name, "n": g.n, "m": g.m, "ordering": p.ordering,
          "engine": p.engine_name, "sigma": p.bvss.sigma,
          "num_vss": p.bvss.num_vss,
          "max_vss_per_set": p.bvss.max_vss_per_set,
          "prepare_s": prep_s, "sources": rows, "launches": counts,
          "card": card})
    return p, counts


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.core.bfs import make_blest_bfs, make_engine
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    # phase 1: build and identify
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    emit({"nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    build_s = _build.build_all()
    emit({"phase": "build", "build_s": build_s,
          "libraries": [_build.library_path(s).name for s in _build.SOURCES]})

    # phase 2: kernels against twins
    timed = phase_kernels(torch, rt)

    # phase 3: main path, road regime (counts read from this run)
    rng = np.random.default_rng(SEED)
    g = rt.generators.grid2d(2048, 2048)
    sources = [0] + [int(s) for s in rng.choice(g.n, 3, replace=False)]
    oracle = memo_oracle(rt)
    p, main_counts = bfs_phase(torch, rt, "main_path_grid2d_2048", g,
                               sources, card, oracle)
    missing = [k for k, c in main_counts.items() if c == 0]
    if missing:
        fail(f"main path never launched {missing}: {main_counts}")
    profile_levels(torch, make_blest_bfs(p.problem, lazy=False,
                                         max_levels=PROFILE_LEVELS),
                   int(p.perm[0]), "grid2d_2048", card, PROFILE_LEVELS)

    # phase 4: the lazy engine on the same prepared graph
    lazy = make_engine(p.graph, "blest_lazy", problem=p.problem)
    reset_launch_counts()
    rows = run_sources(
        torch, g, lambda s: lazy(int(p.perm[s])).cpu().numpy()[p.perm],
        sources[:2], oracle)
    lazy_counts = launch_counts()
    if lazy_counts["finalize_pack_sweep"] == 0:
        fail("the lazy engine never launched finalize_pack_sweep")
    emit({"phase": "lazy_grid2d_2048", "sources": rows,
          "launches": lazy_counts, "card": card})
    del lazy, p
    torch.cuda.empty_cache()

    # phase 5: main path, social regime
    g = rt.generators.rmat(18)
    sources = [0] + [int(s) for s in rng.choice(g.n, 3, replace=False)]
    p, rmat_counts = bfs_phase(torch, rt, "main_path_rmat_18", g, sources,
                               card, memo_oracle(rt))
    profile_levels(torch, make_blest_bfs(p.problem, lazy=False),
                   int(p.perm[0]), "rmat_18", card, None)

    kernels = []
    replaces = {
        "bvss_pull": "src/repro/kernels/bvss_pull.py:66",
        "bvss_push": "src/repro/kernels/bvss_push.py:52",
        "finalize_pack_sweep": "src/repro/kernels/frontier_finalize.py:124",
    }
    sources_cu = {
        "bvss_pull": "src/repro_torch/kernels/csrc/bvss_pull.cu",
        "bvss_push": "src/repro_torch/kernels/csrc/bvss_push.cu",
        "finalize_pack_sweep":
            "src/repro_torch/kernels/csrc/frontier_finalize.cu",
    }
    for name, row in timed.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources_cu[name],
            "replaces": replaces[name], "launches": main_counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            # the same numbers under the names the port's docs use
            "max_abs_diff": row["max_abs_err"], "kernel_ms": row["ms"],
            "twin_ms": row["plain_ms"],
            "launches_by_phase": {"grid2d_2048": main_counts[name],
                                  "lazy_grid2d_2048": lazy_counts[name],
                                  "rmat_18": rmat_counts[name]},
            **{k: v for k, v in row.items()
               if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
