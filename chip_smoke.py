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
   {1, 4, 8, 32}, words with bit 31 set and frontier bytes with bits above
   sigma included; outputs must be equal; each kernel and twin is timed
   with CUDA events (median) over inputs rotated past L2;
3. main path, road regime: ``repro_torch.GraphSession(grid2d(2048, 2048),
   max_batch=8)`` with default options (RCM, eager ``blest``, direction
   "auto" with push engaged) and ``.levels(src)`` for 4 sources, each equal
   to the host oracle ``reference_bfs``; then the lazy engine
   (``blest_lazy``) on the same prepared graph, and one ``levels_batch``
   cohort of 8 sources (the wave path, batched push engaged since R = 1);
4. main path, social regime: ``GraphSession(rmat(18), max_batch=8)``,
   ``.levels(src)`` for 4 sources, ``levels_batch`` of 24 sources (more
   than the 8 slots, so slots are refilled mid-flight) and
   ``closeness_batch`` of 8 (the fixed-cohort engine, against the SciPy
   oracle ``closeness_ref``);
5. the wave verbs on the symmetrised problem of
   ``GraphSession(rmat(16), max_batch=8)``: ``components()``,
   ``eccentricity_batch`` of 8 sources and ``extremes(max_evals=64)``,
   against the SciPy oracles.  (On rmat(18), 88,297 isolated vertices
   make ``components()`` take minutes; PERF.md has the times.)

Every phase sets the kernels' launch counts to 0 before it and reads them
after, and fails if a kernel of its path never launched.  The profile
phases run ``torch.profiler`` over one BFS or wave of each regime.  Then
one ``{"kernels": [...]}`` line, the card's nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  Bounds use the H100 SXM's
published HBM3 rate, 3.35 TB/s (NVIDIA data sheet).
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
WAVE_PROFILE_LEVELS = 256        # levels of the grid wave under the profiler
SLOTS = 8                        # GraphSession.max_batch of both regimes
SPMM_S = 8                       # = SLOTS: the wave's stacked columns


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
    from repro_torch.kernels import (bvss_pull, bvss_push, bvss_spmm,
                                     finalize_pack_sweep)
    from repro_torch.kernels.ref import (bvss_pull_ref, bvss_push_ref,
                                         bvss_spmm_ref, finalize_pack_ref)
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
        # bvss_spmm: ragged B x S (the 16-byte store path at S % 4 == 0),
        # and the wave's main-path shape on the grid's narrow ladder width
        shapes = [(B, S) for B in (1, 127, 1003) for S in (1, 3, 8, 9, 128)]
        shapes.append((65_536, SPMM_S) if sigma == 8 else (4099, SPMM_S))
        for B, S in shapes:
            m = t(u32_words(rng, (B, 32)))
            fb = t(u32_words(rng, (B, S)))
            check_equal(torch, f"bvss_spmm sigma={sigma} B={B} S={S}",
                        bvss_spmm(m, fb, sigma=sigma),
                        bvss_spmm_ref(m, fb, sigma))
            checked += 1
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
    # the wave pull on the grid's narrow ladder width: 65,536 VSSs, S = 8
    B, S = 65_536, SPMM_S
    spmm_in = rotating(lambda i: (t(u32_words(rng, (B, 32))),
                                  t(u32_words(rng, (B, S)))),
                       B * (32 + S) * 4)
    spmm_bytes = B * 32 * 4 + B * S * 4 + B * spw * 32 * S * 4
    err = check_equal(torch, "bvss_spmm timed",
                      bvss_spmm(*spmm_in[0], sigma=sigma),
                      bvss_spmm_ref(*spmm_in[0], sigma))
    out["bvss_spmm"] = dict(
        shape={"B": B, "S": S, "sigma": sigma}, max_abs_err=err,
        ms=device_ms(torch, lambda m, f: bvss_spmm(m, f, sigma=sigma),
                     spmm_in),
        plain_ms=device_ms(torch, lambda m, f: bvss_spmm_ref(m, f, sigma),
                           spmm_in),
        bound_ms=spmm_bytes / HBM_BYTES_PER_S * 1e3)
    emit({"phase": "kernels_vs_twins", "cases_equal": checked,
          "tolerance": "exact (max abs err 0)"})
    return out


# ---------------------------------------------------------------------------
# phases 3-5: BFS, waves and verbs through the public entry points
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
    """``reference_bfs`` remembered per source (the phases of one regime
    share a graph and sources)."""
    memo = {}

    def oracle(g, s):
        if s not in memo:
            memo[s] = rt.reference_bfs(g, s)
        return memo[s]

    return oracle


def profile(torch, run, name: str, card: str, **extra) -> None:
    """Where one run's time goes on the card: ``torch.profiler`` over
    ``run()`` after one warm run.  Prints the wall time, the device's busy
    time (the union of its kernel and copy intervals) and idle share, and
    the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    run()                                       # warm: allocator, libraries
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
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
    # device time by launching op and input shapes: tells apart the
    # gathers that share one kernel name
    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": f"profile_{name}", **extra,
          "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3 if spans else None,
          "device_idle_share": 1 - busy_us / wall_us if spans else None,
          "device_events": len(spans),
          "by_kernel": [{"name": k[:90], "device_ms": v[0] / 1e3,
                         "calls": v[1]} for k, v in top],
          "by_op": [{"op": e.key, "shapes": str(e.input_shapes)[:160],
                     "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in ops],
          "card": card})


def require_launches(counts: dict, phase: str, kernels: tuple) -> None:
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        fail(f"{phase} never launched {missing}: {counts}")


def session_phase(torch, rt, name: str, g, sources, card: str, oracle,
                  kernels: tuple):
    """Build ``GraphSession(g, max_batch=SLOTS)`` and serve single-source
    ``levels`` queries against the oracle."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    sess = rt.GraphSession(g, max_batch=SLOTS)
    p = sess.prepared
    reset_launch_counts()
    rows = run_sources(torch, g, sess.levels, sources, oracle)
    counts = launch_counts()
    require_launches(counts, name, kernels)
    emit({"phase": name, "n": g.n, "m": g.m, "ordering": p.ordering,
          "engine": p.engine_name, "sigma": p.bvss.sigma,
          "num_vss": p.bvss.num_vss,
          "max_vss_per_set": p.bvss.max_vss_per_set,
          "prepare_s": sess.preprocess_s, "sources": rows,
          "launches": counts, "card": card})
    return sess, counts


def wave_phase(torch, sess, name: str, g, sources, card: str, oracle
               ) -> dict:
    """One ``levels_batch`` call: every answer equal to the oracle; wall
    time, levels run, host copies and push/pull levels from the engine."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    stats = sess._ms.stats
    before = dict(stats)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lvs = sess.levels_batch(sources)            # ends in host copies
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    require_launches(counts, name, ("bvss_spmm",))
    for s, lv in zip(sources, lvs):
        want = oracle(g, s)
        if lv.dtype != want.dtype or not np.array_equal(lv, want):
            fail(f"{name}: levels of source {s} differ from the oracle")
    delta = {k: stats[k] - before[k] for k in stats}
    levels_run = delta["pull_levels"] + delta["push_levels"]
    if counts["bvss_spmm"] != levels_run:
        fail(f"{name}: {levels_run} levels but {counts['bvss_spmm']} "
             f"bvss_spmm launches")
    emit({"phase": name, "queries": len(sources), "slots": sess.max_batch,
          "wall_ms": wall_s * 1e3, "levels_run": levels_run,
          "ms_per_level": wall_s * 1e3 / max(levels_run, 1),
          "push_levels": delta["push_levels"],
          "pull_levels": delta["pull_levels"],
          "host_syncs": delta["host_syncs"], "launches": counts,
          "card": card})
    return {"counts": counts, **delta}


def closeness_phase(torch, rt, sess, g, sources, card: str) -> dict:
    """``closeness_batch`` (the fixed-cohort engine) against SciPy."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import closeness_ref
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cc = sess.closeness_batch(sources)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    require_launches(counts, "closeness_batch", ("bvss_spmm",))
    want = closeness_ref(g, sources)
    err = float(np.max(np.abs(cc - want) / np.maximum(np.abs(want), 1e-300)))
    if cc.shape != want.shape or not np.all(np.isfinite(cc)) or err > 1e-12:
        fail(f"closeness_batch differs from closeness_ref (rel err {err})")
    stats = sess._dir_wave(len(sources)).engine.stats
    emit({"phase": "closeness_batch_rmat_18", "sources": len(sources),
          "wall_ms": wall_s * 1e3, "max_rel_err": err,
          "tolerance": "rtol 1e-12",
          "levels_run": stats["pull_levels"] + stats["push_levels"],
          "host_syncs": stats["host_syncs"], "launches": counts,
          "card": card})
    return counts


def verbs_phase(torch, rt, sess, g, rng, card: str) -> dict:
    """components, eccentricity_batch and extremes on the session's
    symmetrised problem, against the SciPy oracles; components() is
    profiled once more after the checks."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import (connected_components_ref,
                                         eccentricity_ref)
    t0 = time.perf_counter()
    sess._sym_problem()
    sym_build_s = time.perf_counter() - t0
    gs = g.symmetrized
    reset_launch_counts()
    times = {}
    t0 = time.perf_counter()
    labels = sess.components()
    times["components_s"] = time.perf_counter() - t0
    srcs = [int(s) for s in rng.choice(g.n, SLOTS, replace=False)]
    t0 = time.perf_counter()
    ecc = sess.eccentricity_batch(srcs)
    times["eccentricity_batch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = sess.extremes(max_evals=64)
    times["extremes_s"] = time.perf_counter() - t0
    counts = launch_counts()
    require_launches(counts, "verbs", ("bvss_spmm", "bvss_pull",
                                       "finalize_pack_sweep"))
    t0 = time.perf_counter()
    want = connected_components_ref(g)
    if not np.array_equal(labels, want):
        fail("components() differs from connected_components_ref")
    if not np.array_equal(ecc, eccentricity_ref(gs, srcs)):
        fail("eccentricity_batch differs from eccentricity_ref")
    # the report's witnesses: periphery has eccentricity diameter_lb,
    # center has radius_ub, both in the largest component
    big = np.bincount(want).argmax()
    wit = eccentricity_ref(gs, [rep.periphery, rep.center])
    if not (want[rep.periphery] == big and want[rep.center] == big
            and wit[0] == rep.diameter_lb and wit[1] == rep.radius_ub
            and rep.diameter_lb <= rep.diameter_ub):
        fail(f"extremes() disagrees with eccentricity_ref: {rep}, "
             f"witnesses {wit.tolist()}")
    emit({"phase": "verbs_rmat_16_symmetrised", "n": gs.n, "m": gs.m,
          "sym_build_s": sym_build_s, **times,
          "oracle_s": time.perf_counter() - t0,
          "components": int(labels.max()) + 1,
          "eccentricities": ecc.tolist(),
          "extremes": {"diameter_lb": rep.diameter_lb,
                       "diameter_ub": rep.diameter_ub,
                       "radius_ub": rep.radius_ub,
                       "n_ecc_evals": rep.n_ecc_evals},
          "wave_stats": dict(sess._sym_ms().stats),
          "launches": counts, "card": card})
    profile(torch, sess.components, "components_rmat_16", card)
    return counts


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
    from repro_torch.core.multi_source import make_multi_source_bfs
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    # phase 1: build and identify
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = smi
    emit({"nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    build_s = _build.build_all()
    emit({"phase": "build", "build_s": build_s,
          "libraries": [_build.library_path(s).name for s in _build.SOURCES]})

    # phase 2: kernels against twins
    timed = phase_kernels(torch, rt)
    by_phase: dict = {}

    # phase 3: main path, road regime (counts read from this run)
    rng = np.random.default_rng(SEED)
    g = rt.generators.grid2d(2048, 2048)
    sources = [0] + [int(s) for s in rng.choice(g.n, 3, replace=False)]
    oracle = memo_oracle(rt)
    sess, main_counts = session_phase(
        torch, rt, "main_path_grid2d_2048", g, sources, card, oracle,
        ("bvss_pull", "bvss_push", "finalize_pack_sweep"))
    by_phase["grid2d_2048"] = main_counts
    p = sess.prepared
    bfs = make_blest_bfs(p.problem, lazy=False, max_levels=PROFILE_LEVELS)
    profile(torch, lambda: bfs(int(p.perm[0])), "grid2d_2048", card,
            levels_cap=PROFILE_LEVELS)

    # the lazy engine on the same prepared graph
    lazy = make_engine(p.graph, "blest_lazy", problem=p.problem)
    reset_launch_counts()
    rows = run_sources(
        torch, g, lambda s: lazy(int(p.perm[s])).cpu().numpy()[p.perm],
        sources[:2], oracle)
    by_phase["lazy_grid2d_2048"] = launch_counts()
    require_launches(by_phase["lazy_grid2d_2048"], "the lazy engine",
                     ("finalize_pack_sweep",))
    emit({"phase": "lazy_grid2d_2048", "sources": rows,
          "launches": by_phase["lazy_grid2d_2048"], "card": card})
    del lazy

    # the wave path, road regime: one cohort of 8 (the 4 above + 4 new)
    cohort = sources + [int(s) for s in rng.choice(g.n, SLOTS - 4,
                                                   replace=False)]
    wave = wave_phase(torch, sess, "wave_grid2d_2048", g, cohort, card,
                      oracle)
    by_phase["wave_grid2d_2048"] = wave["counts"]
    if wave["push_levels"] == 0:
        fail("the grid wave never took the batched push branch")
    internal = p.perm[np.asarray(cohort)]
    bfs = make_multi_source_bfs(None, SLOTS, problem=p.problem,
                                max_levels=WAVE_PROFILE_LEVELS)
    profile(torch, lambda: bfs(internal), "wave_grid2d_2048", card,
            levels_cap=WAVE_PROFILE_LEVELS)
    del sess, p, bfs
    torch.cuda.empty_cache()

    # phase 4: main path, social regime
    g = rt.generators.rmat(18)
    sources = [0] + [int(s) for s in rng.choice(g.n, 3, replace=False)]
    oracle = memo_oracle(rt)
    sess, by_phase["rmat_18"] = session_phase(
        torch, rt, "main_path_rmat_18", g, sources, card, oracle,
        ("bvss_pull", "finalize_pack_sweep"))
    p = sess.prepared
    bfs = make_blest_bfs(p.problem, lazy=False)
    profile(torch, lambda: bfs(int(p.perm[0])), "rmat_18", card)
    queries = [int(s) for s in rng.choice(g.n, 3 * SLOTS, replace=False)]
    wave = wave_phase(torch, sess, "wave_rmat_18", g, queries, card, oracle)
    by_phase["wave_rmat_18"] = wave["counts"]
    profile(torch, lambda: sess.levels_batch(queries), "wave_rmat_18", card,
            queries=len(queries), levels_run=wave["pull_levels"]
            + wave["push_levels"], host_syncs=wave["host_syncs"])
    by_phase["closeness_rmat_18"] = closeness_phase(
        torch, rt, sess, g, [int(s) for s in rng.choice(g.n, SLOTS,
                                                        replace=False)],
        card)

    del sess, p, bfs
    torch.cuda.empty_cache()

    # phase 5: the wave verbs on the symmetrised problem, cut to rmat(16)
    g = rt.generators.rmat(16)
    t0 = time.perf_counter()
    sess = rt.GraphSession(g, max_batch=SLOTS)
    emit({"phase": "prepare_rmat_16", "n": g.n, "m": g.m,
          "prepare_s": time.perf_counter() - t0, "card": card})
    by_phase["verbs_rmat_16"] = verbs_phase(torch, rt, sess, g, rng, card)

    replaces = {
        "bvss_pull": "src/repro/kernels/bvss_pull.py:66",
        "bvss_push": "src/repro/kernels/bvss_push.py:52",
        "finalize_pack_sweep": "src/repro/kernels/frontier_finalize.py:124",
        "bvss_spmm": "src/repro/kernels/mxu_pull.py:156",
    }
    sources_cu = {
        "bvss_pull": "src/repro_torch/kernels/csrc/bvss_pull.cu",
        "bvss_push": "src/repro_torch/kernels/csrc/bvss_push.cu",
        "finalize_pack_sweep":
            "src/repro_torch/kernels/csrc/frontier_finalize.cu",
        "bvss_spmm": "src/repro_torch/kernels/csrc/bvss_spmm.cu",
    }
    # each kernel's launches on its own main path: the single-source BFSs of
    # the road regime for the first three, the two waves for bvss_spmm
    main_path = {"bvss_spmm": ("wave_grid2d_2048", "wave_rmat_18")}
    kernels = []
    for name, row in timed.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources_cu[name],
            "replaces": replaces[name],
            "launches": sum(by_phase[ph][name]
                            for ph in main_path.get(name, ("grid2d_2048",))),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            # the same numbers under the names the port's docs use
            "max_abs_diff": row["max_abs_err"], "kernel_ms": row["ms"],
            "twin_ms": row["plain_ms"],
            "launches_by_phase": {ph: c[name] for ph, c in by_phase.items()},
            **{k: v for k, v in row.items()
               if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
