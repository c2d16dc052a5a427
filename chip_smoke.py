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
   sigma included, +inf weights and distances for the min-plus tile,
   ``bvss_spmm`` frontier rows and ``finalize_pack_sweep`` operands one
   element off 16-byte alignment; ``bit_spmm`` at ragged R x C x S with
   int8 X over [0, 2) and [-128, 128) and bits set beyond C,
   ``finalize_sweep`` at ragged N; ``bvss_spmm_w`` and ``bvss_spmm_t`` at
   B in {1, 7, 8, 9, 127, 1003} x S in {1, 2, 3, 4, 8, 9, 16, 32, 128}
   and with values and rows one float off 16-byte alignment, over words
   with all-zero, single-bit and bit-31 words and values with -0.0 and
   subnormals throughout and a few +inf (at least 90% of every case's
   outputs finite);
   integer outputs and ``bvss_spmm_minplus`` must be equal, ``bvss_spmm_w``
   and ``bvss_spmm_t`` equal bit for bit (they add in their twins' order);
   each kernel and twin is timed with CUDA events (median) over inputs
   rotated past L2, and the two weighted tiles beside ``torch.bmm`` over
   the unpacked f32 tile (TF32 off), the library call that computes the
   same product (and ``bvss_spmm`` beside it at its own shape);
   ``bvss_push`` also at B = 1 and 16,384 (the launch floor
   control); ``bvss_spmm`` and ``finalize_pack_sweep`` also at a second
   shape (a wide wave, B = 4,096, S = 128; the lazy sweep at N =
   1,048,576); the redesigned kernels with ``share`` = bound / time, and
   ``bvss_spmm`` beside ``fill_`` over its output bytes, the card's own
   write stream; then ``bvss_push_level``, the one-launch push level,
   against its twin, eager and lazy, every sigma, on rmat(15) and
   grid2d(256, 256), frontiers of 1, 128 and 16,384 vertices;
3. main path, road regime: ``repro_torch.GraphSession(grid2d(2048, 2048),
   max_batch=8)`` with default options (RCM, eager ``blest``, direction
   "auto" with push engaged) and ``.levels(src)`` for 4 sources, each equal
   to the host oracle ``reference_bfs``, every push level one
   ``bvss_push_level`` launch; ``bvss_push_level`` timed at the grid's own
   push frontiers (see ``push_level_timing``) beside its byte bound, the
   unfused push level and the launch floor; the first 128 levels from the
   corner (all push levels) profiled through ``bvss_push_level`` and
   through the unfused ``push_impl`` seam around ``bvss_push``; then the
   lazy engine (``blest_lazy``) on the same prepared graph, one BFS
   through the push seam, and one ``levels_batch`` cohort of 8 sources
   (the wave path, batched push engaged since R = 1);
4. main path, social regime: ``GraphSession(rmat(18), max_batch=8)``,
   ``.levels(src)`` for 4 sources, ``levels_batch`` of 24 sources (more
   than the 8 slots, so slots are refilled mid-flight) and
   ``closeness_batch`` of 8 (the fixed-cohort engine, against the SciPy
   oracle ``closeness_ref``);
   The rmat(18) session is weighted (``weights=`` dyadic weights k/32
   drawn from SEED), so the same preparation then serves the
   float-channel verbs: ``betweenness_batch`` of 8 sources against the
   level-synchronous Brandes oracle ``betweenness_ref`` (then profiled),
   ``bvss_spmm_w`` and ``bvss_spmm_t`` timed again on the session's own
   mask words (real slices are sparse), ``sssp_batch``
   of 8 and ``sssp(src)`` against SciPy's Dijkstra (exactly: dyadic sums
   are exact in float32) and ``pagerank()`` against the float64 power
   iteration ``pagerank_ref``;
5. the wave verbs on the symmetrised problem of
   ``GraphSession(rmat(16), max_batch=8)``: ``components()``,
   ``eccentricity_batch`` of 8 sources and ``extremes(max_evals=64)``,
   against the SciPy oracles, and ``sssp_batch`` of 4 sources on the
   unweighted session (its lazy unit-weight plane) against the BFS
   levels.  (On rmat(18), 88,297 isolated vertices make ``components()``
   take minutes; PERF.md has the times.)  Then the dense multi-source
   baseline on the same directed rmat(16): the ``to_dense_bits``
   adjacency, ``make_dense_multi_source_bfs`` (``bit_spmm`` a level)
   against the BVSS multi-source engine on 8 sources, ``dense_pull`` from
   one, and ``bit_spmm`` timed at this shape against its twin (in row
   chunks) and ``torch._int_mm`` over the unpacked int8 adjacency;
6. the paper's Table-2 matrix: every variant of
   ``repro_torch.launch.bfs.ENGINE_VARIANTS`` (BLEST a/ab/ac/full, BRS,
   CSR push/pull, dirop) on rmat(18) (reusing phase 4's ordered
   preparation) and on the launcher's ``road`` graph at scale 20,
   ``grid2d(1024, 1024, shuffle=True)``: one warm and two timed BFSs each,
   equal to the oracle, ms per BFS and speedup against ``brs``; on the
   road graph ``brs``, ``blest_a`` and ``csr_push`` are profiled over
   their first TABLE2_PROFILE_LEVELS levels, and ``bvss_push_level`` is
   timed at its push frontiers;
7. ``repro_torch.bench.kernel_bench.run()`` (the path of
   ``finalize_sweep``, beside the fused lazy sweep) and the launcher
   ``python -m repro_torch.launch.bfs`` in process for every variant on a
   small road graph, each ending ``VERIFIED vs oracle``;
8. the analytics launcher ``python -m repro_torch.launch.analytics`` in
   process on rmat(14), every verb of its ``WHAT`` (all but ``extremes``
   ending ``VERIFIED``; ``launch_analytics``); the paper's host Tables
   1a, 1b and 4 at the reference's sizes, their derived columns equal to
   the JAX package's (``PAPER_TABLE_DERIVED``; ``paper_tables_host``);
   Figure 3, compression and ms per BFS for windows 8 ... 4096 on
   ``clustered(256, 64)`` (``fig3_clustered_16``, cut to scale 14); the
   RMAT scale sweep at scales 14, 16 and 18, MTEPS and the
   ``memory_bytes`` model beside ``torch.cuda.max_memory_allocated``
   (``bench_scale_rmat``); and ``bench_analytics.run(scale=12)``, the
   wave verbs against sequential baselines and the oracles;
9. the hardened serving tier: ``rmat(18)`` opened once through
   ``GraphSessionManager(verify_fraction=1.0)`` (Jaccard, eager ``blest``,
   8 slots): ``levels_batch`` of 24 sources, every answer the oracle's and
   verified, no quarantine; ``betweenness`` and ``closeness`` of 8
   through the finite guards; the bare session against the manager with
   a never-firing deadline; ``session_cost_bytes`` beside
   ``max_memory_allocated`` over the open and over the wave alone
   (``serve_manager_rmat_18``); a ``RequestQueue`` over it: first
   ``bench_queue``'s call-at-a-time against queued comparison of its 24
   requests, verification off, then 24 requests from two tenants (the
   second on its own session of the same graph), four slots each,
   staggered ``not_before``, once through ``drain()`` and once through the
   ``start()`` pump with two submitting threads, every future the
   oracle's and requests coalescing (``serve_queue_rmat_18``); the launch
   counter's lock against a plain increment, per call and on the wave
   (``launch_counter``); on
   ``grid2d(512, 512)`` a 0.2 s deadline over a whole call and over one
   queued request of eight, each harvest the oracle's levels up to its
   depth (``serve_deadline_grid_512``); the fault gauntlet on ``rmat(16)``,
   ``corrupt_spmm_tile``, ``corrupt_push_tile`` (forced push, through
   ``bvss_push``, never ``bvss_push_level``) and ``nan_sigma``, each
   diverging unverified and quarantined and correct verified, and a clean
   ``FaultPlan()`` session never quarantined (``serve_faults_rmat_16``);
   the launcher's ``--service --queue --verify-fraction 1.0`` on ``road``
   scale 16 (``launch_service``); and ``bench_service`` and
   ``bench_queue`` at their default size (``bench_service_serve``,
   ``bench_queue``);
10. autotuning and streaming edge updates, each part right after the
   phase whose graph it reuses: ``prepare(p.graph, order=False,
   engine=p.engine_name, autotune=True)`` on phase 3's ordered grid and
   phase 4's ``rmat(18)`` (``autotune_grid``, ``autotune_rmat_18``: the
   TileConfig, ``tune``'s seconds and ``bvss_pull``/``bvss_push``
   launches, the 4 sources' levels equal to the oracle, ms per BFS and push
   levels against the defaults', and a second prepare of the class with no
   tuning run, one cache hit and no launch); ``update_edges`` on phase 4's
   weighted session (``update_edges_rmat_18``: 256 inserts with dyadic
   weights and 256 deletes on the patched path, 64 reweights, one insert
   that grows a slice set's VSS count on the rebuilt path; after each swap
   ``levels`` of 4 sources, a wave of 24 through 8 slots, a betweenness
   cohort of 8 and ``sssp`` against the oracles of the mutated graph; the
   epoch-0 ``PreparedBFS``'s masks and answers unchanged, and a wave whose
   hook updates the session mid-flight answering on its own epoch); phase
   5's ``rmat(16)`` with ``staleness_budget=1`` (``update_reprepare_
   rmat_16``, the reprepared path); phase 9's manager, verified, an update
   then a queued drain (``update_serving_rmat_18``); and ``bench_hybrid``
   at scale 18, the tuned hybrid against the pull-only engine, every graph
   verified in all three directions (``bench_hybrid``);
11. the mesh-native BFS on ``torch.distributed`` at world size 1 (one
   NCCL rank: a card holds one, so multi-card NCCL is not exercised),
   each part right after the phase whose ordered graph it reuses:
   ``prepare(p.graph, order=False, mesh=bfs_mesh(1))`` on phase 3's grid
   and phase 4's ``rmat(18)``, the 1-D eager engine for the phase's
   sources and the lazy one (the grid: for two, as phase 3's lazy), the
   sharded BRS and the 2-D ``bfs_mesh2d(1, 1)`` engine for the first
   source (on the grid cut at PROFILE_LEVELS levels), each equal to the
   oracle with its kernels launched on the shard (2-D: ``bvss_pull``
   alone), ms per BFS beside the single-device phase's, the comm
   ledger's bytes a level and the device-to-host synchronisations a
   level (CUDA's sync debug mode, one extra run, on the grid cut at
   MESH_PROFILE_LEVELS levels); the grid's sharded and single-device
   eager BFSs profiled over MESH_PROFILE_LEVELS levels, device and host
   (``mesh_grid2d_2048``, ``profile_mesh_grid2d_2048_single`` and
   ``_mesh``, ``mesh_rmat_18``); then
   ``python -m repro_torch.launch.bfs --devices 1`` in a child process
   ending ``VERIFIED vs oracle`` and ``--devices 2`` raising
   ``ConfigError`` on one card (``mesh_launch_cli``).

Every phase sets the kernels' launch counts to 0 before it and reads them
after, and fails if a kernel of its path never launched; the
single-source phases also fail unless every push level was one
``bvss_push_level`` launch and ``bvss_push`` never ran.  Every phase line
carries its wall seconds (``phase_s``, since the previous phase line).
The profile phases run ``torch.profiler`` over one BFS, wave or cohort of
each path (for ``components()``, over its first COMPONENTS_PROFILE_SEEDS
refill floods).  Then one ``{"kernels": [...]}`` line, the card's nvidia-smi
line, and as the last line ``{"ok": true, "device": {...}}``.  Bounds use
the H100 SXM's published HBM3 rate, 3.35 TB/s (NVIDIA data sheet).
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
TABLE2_SOURCES = 2               # timed BFSs per Table-2 variant and graph
COMPONENTS_PROFILE_SEEDS = 256   # floods of the components() profile
CLI_SCALE = 12                   # the launcher's road graph: 64 x 64
TABLE2_PROFILE_LEVELS = 128      # levels of each profiled Table-2 engine

# the derived columns of the paper's host tables at their default sizes
# (Table 1a n = 4,096, Table 1b and Table 4 scale 11): the JAX package's
# rows, which tests/test_torch_paper_tables.py holds the port to on the CPU
PAPER_TABLE_DERIVED = {
    "table1a/natural": "compression=0.138",
    "table1a/random": "compression=0.138",
    "table1a/shingle(gorder-lite)": "compression=0.147",
    "table1a/rcm": "compression=0.138",
    "table1a/jaccard_windows": "compression=0.155",
    "table1b/road(grid)": "udiv_before=572;udiv_after=30;reduction=19.1x",
    "table1b/rgg": "udiv_before=202;udiv_after=31;reduction=6.4x",
    "table1b/path": "udiv_before=3;udiv_after=3;reduction=1.0x",
    "table4/kron": "n_sets=256;num_vss=312;slices=18387;"
                   "padded_slices=39936;conn_bits=147096;udiv=236;"
                   "compression=0.173;mem_mb=0.23",
    "table4/urand": "n_sets=256;num_vss=339;slices=31777;"
                    "padded_slices=43392;conn_bits=254216;udiv=117;"
                    "compression=0.128;mem_mb=0.24",
    "table4/road": "n_sets=254;num_vss=254;slices=7881;padded_slices=32512;"
                   "conn_bits=63048;udiv=572;compression=0.126;mem_mb=0.18",
    "table4/web": "n_sets=256;num_vss=510;slices=41141;padded_slices=65280;"
                  "conn_bits=329128;udiv=100;compression=0.130;mem_mb=0.35",
    "table4/rgg": "n_sets=256;num_vss=256;slices=19758;padded_slices=32768;"
                  "conn_bits=158064;udiv=202;compression=0.127;mem_mb=0.18",
    "table4/star": "n_sets=256;num_vss=271;slices=2303;padded_slices=34688;"
                   "conn_bits=18424;udiv=1;compression=0.222;mem_mb=0.22",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


_PHASE_CLOCK = [time.perf_counter()]


def emit(obj: dict) -> None:
    """Print one JSON line; a phase line gets ``phase_s``, the wall seconds
    since the previous phase line (the phases run one after another)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_s": now - _PHASE_CLOCK[0]}
        _PHASE_CLOCK[0] = now
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def device_ms(torch, fn, inputs: list, reps: int = 20) -> float:
    """Median device time of one ``fn(*inp)`` call, in ms (the median of
    :func:`device_samples`)."""
    return statistics.median(device_samples(torch, fn, inputs, reps))


def device_samples(torch, fn, inputs: list, reps: int = 20) -> list:
    """Five samples of the device time of one ``fn(*inp)`` call, in ms.

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
    return samples


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
    from repro_torch.kernels import (bit_spmm, bvss_pull, bvss_push,
                                     bvss_spmm, finalize_pack_sweep,
                                     finalize_sweep)
    from repro_torch.kernels.ref import (bit_spmm_ref, bvss_pull_ref,
                                         bvss_push_ref, bvss_spmm_ref,
                                         finalize_pack_ref,
                                         finalize_sweep_ref)
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
        # bvss_spmm: ragged B x S (the 16-byte store path at S in {4, 8,
        # ..., 128}), frontier rows off 16-byte alignment (offset 1), and
        # the wave's main-path shape on the grid's narrow ladder width
        shapes = [(B, S, 0) for B in (1, 127, 1003)
                  for S in (1, 3, 4, 8, 9, 16, 128)]
        shapes += [(1003, 3, 1), (1003, 8, 1)]
        shapes.append((65_536, SPMM_S, 0) if sigma == 8
                      else (4099, SPMM_S, 0))
        for B, S, off in shapes:
            m = t(u32_words(rng, (B, 32)))
            fb = t(u32_words(rng, (B * S + off,)))[off:].view(B, S)
            check_equal(torch, f"bvss_spmm sigma={sigma} B={B} S={S} "
                        f"offset={off}", bvss_spmm(m, fb, sigma=sigma),
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
        # views one element off alignment (the one-vertex path), both modes
        for mk in (None, marks[1:]):
            check_equal(torch, f"finalize view sigma={sigma} N={N - 1} "
                        f"lazy={mk is not None}",
                        finalize_pack_sweep(levels[1:], lvl, marks=mk, **kw),
                        finalize_pack_ref(levels[1:], lvl, marks=mk, **kw))
            checked += 1
    # bit_spmm: ragged R x C x S, bits beyond C set in every last word (they
    # count nothing), X in {0, 1} and over all of int8
    for R in (1, 17, 130, 4099):
        for C in (1, 31, 33, 260, 4096):
            for S in (1, 8, 129):
                for lo, hi in ((0, 2), (-128, 128)):
                    a = u32_words(rng, (R, (C + 31) // 32))
                    a[:, -1] |= np.int32(-2 ** 31)
                    a, x = t(a), t(rng.integers(lo, hi, (C, S)).astype(
                        np.int8))
                    check_equal(torch, f"bit_spmm R={R} C={C} S={S} "
                                f"x in [{lo}, {hi})", bit_spmm(a, x),
                                bit_spmm_ref(a, x))
                    checked += 1
    for N in (1, 31, 1025, 4_194_305):
        lv = rng.choice(np.array([INF, 6, 2], np.int32), N)
        marks = t(rng.integers(0, 3, N).astype(np.uint8))
        check_equal(torch, f"finalize_sweep N={N}",
                    finalize_sweep(marks, t(lv), 7),
                    finalize_sweep_ref(marks, t(lv), 7))
        checked += 1
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

    def push_timing(B):
        """bvss_push at B queued VSSs: inputs and a row with the median,
        the five samples and the bound, in ms."""
        ins = rotating(lambda i: (
            t(u32_words(rng, (B, 32))),
            t(rng.integers(0, sigma, B).astype(np.int32))), B * 132)
        nbytes = B * 32 * 4 + B * 4 + B * spw * 32
        samples = device_samples(
            torch, lambda m, b: bvss_push(m, b, sigma=sigma), ins)
        return ins, dict(shape={"B": B, "sigma": sigma},
                         ms=statistics.median(samples), samples_ms=samples,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)

    B = 128                         # push_cap * max_vss_per_set on the grid
    push_in, row = push_timing(B)
    row["max_abs_err"] = check_equal(torch, "bvss_push timed",
                                     bvss_push(*push_in[0], sigma=sigma),
                                     bvss_push_ref(*push_in[0], sigma))
    row["plain_ms"] = device_ms(
        torch, lambda m, b: bvss_push_ref(m, b, sigma), push_in)
    # the control: one VSS and a wide queue beside B = 128, same body; equal
    # times at B = 1 and 128 put the kernel at the card's launch floor
    for B in (1, 16_384):
        row[f"b{B}"] = push_timing(B)[1]
    out["bvss_push"] = row

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
    row = dict(
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
    row.update(share=row["bound_ms"] / row["ms"],
               lazy_share=row["lazy_bound_ms"] / row["lazy_ms"])
    out["finalize_pack_sweep"] = row
    # the unit sweep at the same N: marks and levels in, levels' and flags
    # out, 10 B a vertex
    sweep_bytes = N + N * 4 + N * 4 + N
    err = check_equal(torch, "finalize_sweep timed",
                      finalize_sweep(fin_in[0][1], fin_in[0][0], lvl),
                      finalize_sweep_ref(fin_in[0][1], fin_in[0][0], lvl))
    out["finalize_sweep"] = dict(
        shape={"N": N}, max_abs_err=err,
        ms=device_ms(torch, lambda lv, mk: finalize_sweep(mk, lv, lvl),
                     fin_in),
        plain_ms=device_ms(
            torch, lambda lv, mk: finalize_sweep_ref(mk, lv, lvl), fin_in),
        bound_ms=sweep_bytes / HBM_BYTES_PER_S * 1e3, library_ms=None)
    del fin_in
    # the lazy sweep at the launcher's road graph, scale 20: N = 1,048,576,
    # the shape of the Table-2 road matrix's sweeps
    N = 1_048_576                   # fin_inputs reads N when called
    kw = dict(sigma=sigma, n_fwords=N // 32, n_sets=N // sigma)
    road_in = rotating(fin_inputs, N * 5)
    road_bytes = N * 4 + N + N * 4 + N // 32 * 4 + N // sigma
    check_equal(torch, "finalize lazy road timed",
                finalize_pack_sweep(road_in[0][0], lvl, marks=road_in[0][1],
                                    **kw),
                finalize_pack_ref(road_in[0][0], lvl, marks=road_in[0][1],
                                  **kw))
    ms = device_ms(torch, lambda lv, mk: finalize_pack_sweep(
        lv, lvl, marks=mk, **kw), road_in)
    row["road_lazy"] = dict(shape={"N": N, "sigma": sigma, "mode": "lazy"},
                            ms=ms, bound_ms=road_bytes / HBM_BYTES_PER_S * 1e3,
                            share=road_bytes / HBM_BYTES_PER_S * 1e3 / ms)
    del road_in
    # the wave pull on the grid's narrow ladder width: 65,536 VSSs, S = 8
    B, S = 65_536, SPMM_S
    spmm_in = rotating(lambda i: (t(u32_words(rng, (B, 32))),
                                  t(u32_words(rng, (B, S)))),
                       B * (32 + S) * 4)
    spmm_bytes = B * 32 * 4 + B * S * 4 + B * spw * 32 * S * 4
    err = check_equal(torch, "bvss_spmm timed",
                      bvss_spmm(*spmm_in[0], sigma=sigma),
                      bvss_spmm_ref(*spmm_in[0], sigma))
    out_bytes = B * spw * 32 * S * 4
    fill_out = torch.empty(out_bytes // 4, dtype=torch.int32, device=cuda)
    row = dict(
        shape={"B": B, "S": S, "sigma": sigma}, max_abs_err=err,
        ms=device_ms(torch, lambda m, f: bvss_spmm(m, f, sigma=sigma),
                     spmm_in),
        plain_ms=device_ms(torch, lambda m, f: bvss_spmm_ref(m, f, sigma),
                           spmm_in),
        bound_ms=spmm_bytes / HBM_BYTES_PER_S * 1e3,
        # the card's own write stream over the same output bytes
        fill_ms=device_ms(torch, lambda m, f: fill_out.fill_(1), spmm_in))
    row["share"] = row["bound_ms"] / row["ms"]
    # the library call for the same product: torch.bmm of the unpacked f32
    # slice bits (B, τ, σ) against the unpacked f32 frontier bits (B, σ, S),
    # TF32 off; the unpack is outside the clock.  Counts <= σ are exact in
    # f32, so the product must equal the kernel's counts
    m, f = spmm_in[0]
    shifts = (torch.arange(spw, device=cuda) * sigma)[:, None, None]
    bits = torch.arange(sigma, device=cuda)
    a = ((m.to(torch.int64) & 0xFFFFFFFF)[:, None, :, None]
         >> (shifts + bits)) & 1
    a = a.reshape(B, spw * 32, sigma).to(torch.float32)
    x = ((f.to(torch.int64)[:, None, :] >> bits[None, :, None]) & 1).to(
        torch.float32)                              # (B, σ, S)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_out = torch.bmm(a, x).reshape(B, spw, 32, S)
    row["library_err"] = check_equal(
        torch, "bvss_spmm bmm", lib_out.to(torch.int32),
        bvss_spmm(m, f, sigma=sigma))
    row["library_ms"] = device_ms(torch, lambda a, x: torch.bmm(a, x),
                                  [(a, x)])
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    del spmm_in, fill_out, a, x, lib_out
    # a wide wave: S = 128 columns, the same 268 MB of output
    B, S = 4096, 128
    wide_in = rotating(lambda i: (t(u32_words(rng, (B, 32))),
                                  t(u32_words(rng, (B, S)))),
                       B * (32 + S) * 4)
    wide_bytes = B * 32 * 4 + B * S * 4 + B * spw * 32 * S * 4
    check_equal(torch, "bvss_spmm wide timed",
                bvss_spmm(*wide_in[0], sigma=sigma),
                bvss_spmm_ref(*wide_in[0], sigma))
    ms = device_ms(torch, lambda m, f: bvss_spmm(m, f, sigma=sigma), wide_in)
    row["wide"] = dict(shape={"B": B, "S": S, "sigma": sigma}, ms=ms,
                       bound_ms=wide_bytes / HBM_BYTES_PER_S * 1e3,
                       share=wide_bytes / HBM_BYTES_PER_S * 1e3 / ms)
    out["bvss_spmm"] = row
    emit({"phase": "kernels_vs_twins", "cases_equal": checked,
          "tolerance": "exact (max abs err 0)"})
    return out


# ---------------------------------------------------------------------------
# the one-launch push level: against its twin, and timed on real frontiers
# ---------------------------------------------------------------------------
FORCED_FRONTIER = 16_384         # a forced push level's frontier (vertices)
PUSH_TIMED_FRONTIERS = 8         # distinct frontiers of a push-level timing
PUSH_PROFILE_LEVELS = 128        # a grid BFS from its corner pushes these


def pack_frontier(torch, verts, n_fwords: int, device):
    """Packed frontier words (n_fwords,) int32 with the bits ``verts``."""
    from repro_torch.kernels.ref import pack_words
    bits = torch.zeros(n_fwords * 32, dtype=torch.bool, device=device)
    bits[torch.as_tensor(np.asarray(verts, np.int64), device=device)] = True
    return pack_words(bits)


def phase_push_level(torch, rt) -> int:
    """bvss_push_level against its twin, eager and lazy, every σ, on
    rmat(15) (R from 4 to 259; isolated vertices, so empty slice sets) and
    grid2d(256, 256) (R = 1 up to σ = 16): frontiers of one vertex with
    out-edges, of DEFAULT_PUSH_CAP vertices and of FORCED_FRONTIER; levels
    mixing INF with levels below, at and above lvl, marks holding stale
    values.  The whole arrays must be equal, slot n included."""
    from repro_torch.core.bfs import DEFAULT_PUSH_CAP, BlestProblem
    from repro_torch.core.bvss import build_bvss
    from repro_torch.kernels import bvss_push_level
    from repro_torch.kernels.ref import bvss_push_level_ref
    rng = np.random.default_rng(SEED + 2)
    cuda = torch.device("cuda")
    lvl = 5
    checked = 0
    for gname, g in (("rmat_15", rt.generators.rmat(15)),
                     ("grid2d_256", rt.generators.grid2d(256, 256))):
        linked = np.flatnonzero(g.out_degree > 0)
        for sigma in (1, 2, 4, 8, 16, 32):
            p = BlestProblem.build(build_bvss(g, sigma=sigma), cuda)
            dev = p.dev
            for size in (1, DEFAULT_PUSH_CAP, FORCED_FRONTIER):
                verts = (rng.choice(linked, 1) if size == 1
                         else rng.choice(p.n, size, replace=False))
                ops = (pack_frontier(torch, verts, p.n_fwords, cuda),
                       dev.vss_of_vertex_start, dev.vss_of_vertex_end,
                       dev.masks, dev.row_ids, lvl)
                for lazy in (False, True):
                    if lazy:
                        key, out = "marks", rng.integers(0, 3, p.n + 1
                                                         ).astype(np.uint8)
                    else:
                        key, out = "levels", rng.choice(np.array(
                            [INF, 2, lvl - 1, lvl, lvl + 2], np.int32),
                            p.n + 1, p=[0.6, 0.1, 0.1, 0.1, 0.1])
                    out = torch.from_numpy(out).to(cuda)
                    want = bvss_push_level_ref(*ops, sigma,
                                               **{key: out.clone()})
                    check_equal(torch, f"bvss_push_level {gname} "
                                f"sigma={sigma} frontier={size} "
                                f"lazy={lazy}",
                                bvss_push_level(*ops, sigma=sigma,
                                                **{key: out}), want)
                    checked += 1
    torch.cuda.synchronize()
    return checked


def push_level_work(torch, F, dev, sigma: int, lvl: int, levels=None
                    ) -> dict:
    """What one push level over frontier F must touch, counted from the
    data (``push_level_hits``): frontier vertices, (vertex, VSS) pairs,
    hit slots, and the rows it must write (eager: hit rows whose level is
    above lvl; lazy: every hit row); and the bytes: the frontier words
    read once, 8 B of VSS range a vertex, 128 B of mask a pair, 4 B of
    row id (eager: and 4 B of level) a hit slot, 4 B (eager) or 1 B
    (lazy) a written row."""
    from repro_torch.kernels.ref import push_level_hits
    verts, ids, rows = push_level_hits(F, dev.vss_of_vertex_start,
                                       dev.vss_of_vertex_end, dev.masks,
                                       dev.row_ids, sigma)
    if levels is not None:
        written = torch.unique(rows[levels[rows] > lvl]).numel()
    else:
        written = torch.unique(rows).numel()
    nbytes = (F.numel() * 4 + verts.numel() * 8 + ids.numel() * 128
              + rows.numel() * (4 if levels is None else 8)
              + written * (1 if levels is None else 4))
    return {"frontier": verts.numel(), "pairs": ids.numel(),
            "hit_slots": rows.numel(), "rows_written": written,
            "bytes": nbytes}


def push_level_timing(torch, problem, lv: np.ndarray, name: str,
                      card: str) -> dict:
    """bvss_push_level at a graph's own push levels.  ``lv`` holds one
    BFS's levels in the problem's vertex ids; its frontiers of at most
    DEFAULT_PUSH_CAP vertices are the ones an auto push level takes, and
    the PUSH_TIMED_FRONTIERS largest of them are timed, each against the
    levels as they stand before its push (lvl = its level + 1).  Each is
    first held against the twin and against the unfused push level (the
    engine's step around bvss_push, as the push_impl seam runs it), eager
    and lazy.  Then, with the frontier words rotated past L2: the kernel
    beside its byte bound (the mean over the frontiers, see
    push_level_work), the twin, the unfused push level's time (CUDA
    events around the whole composition; ``unfused_busy_ms`` is its
    device busy time under the profiler, without the waits for the host
    that the events include), and bvss_push at B = 1, the launch floor;
    lazy, the kernel and the step (marks memset and kernel) beside the
    unfused lazy level.  The eager stores of a
    frontier happen on its first call only: later calls find the rows
    already at lvl (they are a few hundred bytes a call)."""
    from repro_torch.core.bfs import (DEFAULT_PUSH_CAP, _BlestState,
                                      _make_hybrid_step, queue_widths)
    from repro_torch.kernels import (bvss_push, bvss_push_level,
                                     pull_vss_kernel, push_vss_kernel)
    from repro_torch.kernels.ref import bvss_push_level_ref
    p, dev, cuda = problem, problem.dev, torch.device("cuda")
    n, sigma = p.n, p.sigma
    sizes = np.bincount(lv[lv != INF])
    ks = sorted((k for k in range(len(sizes) - 1)
                 if 1 <= sizes[k] <= DEFAULT_PUSH_CAP),
                key=lambda k: (-sizes[k], k))[:PUSH_TIMED_FRONTIERS]
    if not ks:
        fail(f"{name}: no frontier of at most {DEFAULT_PUSH_CAP} vertices")
    lv_t = torch.from_numpy(np.append(lv, INF).astype(np.int32)).to(cuda)
    fronts, states, work = [], [], []
    for k in ks:
        F = pack_frontier(torch, np.flatnonzero(lv == k), p.n_fwords, cuda)
        levels = torch.where(lv_t <= k, lv_t, INF)
        fronts.append(F)
        states.append(levels)
        work.append(push_level_work(torch, F, dev, sigma, k + 1, levels))
    ops = (dev.vss_of_vertex_start, dev.vss_of_vertex_end, dev.masks,
           dev.row_ids)

    def step_of(push, lazy):
        return _make_hybrid_step(
            dev, pull_vss_kernel, push, sigma, n,
            queue_widths(p.num_vss, 2), lazy=lazy, direction="push",
            num_vss=p.num_vss, n_fwords=p.n_fwords, dummy_vertex=n,
            R=p.max_vss_per_set, push_cap=DEFAULT_PUSH_CAP, alpha=4.0)

    def state_of(F, levels, marks):
        return _BlestState(levels, F, None, 0, marks, n, 0, True)

    unfused = {lazy: step_of(push_vss_kernel, lazy) for lazy in (0, 1)}
    fused = {lazy: step_of(None, lazy) for lazy in (0, 1)}
    marks = torch.zeros(n + 1, dtype=torch.uint8, device=cuda)
    err = 0
    for F, levels, k in zip(fronts, states, ks):
        lvl = k + 1
        got = bvss_push_level(F, *ops, lvl, sigma=sigma,
                              levels=levels.clone())
        err = max(err, check_equal(
            torch, f"{name} push level {lvl} vs twin", got,
            bvss_push_level_ref(F, *ops, lvl, sigma, levels=levels.clone())))
        want = unfused[0](state_of(F, levels.clone(), marks), lvl).levels
        check_equal(torch, f"{name} push level {lvl} vs unfused",
                    got[:n], want[:n])
        got = fused[1](state_of(F, levels, marks.clone()), lvl).marks
        want = unfused[1](state_of(F, levels, marks.clone()), lvl).marks
        check_equal(torch, f"{name} lazy push level {lvl} vs unfused",
                    got[:n], want[:n])
    copies = max(1, -(-2 * L2_BYTES // (p.n_fwords * 4)))
    inputs = [(fronts[i % len(ks)].clone(), states[i % len(ks)],
               ks[i % len(ks)] + 1) for i in range(copies)]
    frontier_marks = [torch.zeros(n + 1, dtype=torch.uint8, device=cuda)
                      for _ in ks]
    lazy_inputs = [(F, frontier_marks[i % len(ks)], lvl)
                   for i, (F, _, lvl) in enumerate(inputs)]

    def kernel(F, lv_, lvl):
        return bvss_push_level(F, *ops, lvl, sigma=sigma, levels=lv_)

    def unfused_eager(F, lv_, lvl):
        return unfused[0](state_of(F, lv_, marks), lvl)

    def kernel_lazy(F, mk, lvl):
        return bvss_push_level(F, *ops, lvl, sigma=sigma, marks=mk)

    def step_lazy(F, mk, lvl):
        return fused[1](state_of(F, lv_t, mk), lvl)

    def unfused_lazy(F, mk, lvl):
        return unfused[1](state_of(F, lv_t, mk), lvl)

    def samples(fn, ins):
        return device_samples(torch, fn, ins, reps=len(ins))

    times = {"kernel": samples(kernel, inputs),
             "unfused": samples(unfused_eager, inputs),
             "kernel_lazy": samples(kernel_lazy, lazy_inputs),
             "step_lazy": samples(step_lazy, lazy_inputs),
             "unfused_lazy": samples(unfused_lazy, lazy_inputs)}
    busy = {"kernel": device_busy_ms(torch, kernel, inputs),
            "unfused": device_busy_ms(torch, unfused_eager, inputs),
            "step_lazy": device_busy_ms(torch, step_lazy, lazy_inputs),
            "unfused_lazy": device_busy_ms(torch, unfused_lazy, lazy_inputs)}
    floor_in = [(torch.zeros((1, 32), dtype=torch.int32, device=cuda),
                 torch.zeros(1, dtype=torch.int32, device=cuda))
                for _ in range(64)]
    floor = samples(lambda m, b: bvss_push(m, b, sigma=sigma), floor_in)
    plain_ms = device_ms(torch, lambda F, lv_, lvl: bvss_push_level_ref(
        F, *ops, lvl, sigma, levels=lv_), inputs)
    lazy_bytes = [push_level_work(torch, F, dev, sigma, k + 1)["bytes"]
                  for F, k in zip(fronts, ks)]
    med = statistics.median
    row = dict(
        shape={"graph": name, "n": n, "n_fwords": p.n_fwords, "sigma": sigma,
               "max_vss_per_set": p.max_vss_per_set, "mode": "eager",
               "frontier_levels": [int(k) for k in ks],
               "frontier_sizes": [int(sizes[k]) for k in ks],
               "rotated_inputs": copies},
        work=work, max_abs_err=err, ms=med(times["kernel"]),
        samples_ms=times["kernel"], plain_ms=plain_ms,
        bound_ms=statistics.mean(w["bytes"] for w in work)
        / HBM_BYTES_PER_S * 1e3, busy_ms=busy["kernel"],
        unfused_ms=med(times["unfused"]),
        unfused_samples_ms=times["unfused"],
        unfused_busy_ms=busy["unfused"],
        launch_floor_ms=med(floor), launch_floor_samples_ms=floor,
        launch_floor="bvss_push at B = 1",
        lazy={"ms": med(times["kernel_lazy"]),
              "samples_ms": times["kernel_lazy"],
              "step_ms": med(times["step_lazy"]),
              "step_samples_ms": times["step_lazy"],
              "step_busy_ms": busy["step_lazy"],
              "unfused_ms": med(times["unfused_lazy"]),
              "unfused_samples_ms": times["unfused_lazy"],
              "unfused_busy_ms": busy["unfused_lazy"],
              "bound_ms": statistics.mean(lazy_bytes)
              / HBM_BYTES_PER_S * 1e3})
    row["share"] = row["bound_ms"] / row["ms"]
    emit({"phase": f"push_level_{name}", **{k: v for k, v in row.items()
                                            if k != "work"},
          "card": card})
    return row


RMAT18_VSS = 38_852              # rmat(18)'s num_vss: the float tiles' width


def check_close(torch, name: str, got, want, rtol: float) -> float:
    """Fail unless the float kernel output is within ``rtol`` of its twin,
    +inf where the twin is +inf; return the largest absolute difference
    over the finite entries."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}, twin "
             f"{want.dtype} {tuple(want.shape)}")
    if torch.isnan(got).any() or not torch.equal(torch.isinf(got),
                                                 torch.isinf(want)):
        fail(f"{name}: kernel NaN or +inf pattern differs from its twin")
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if diff.numel() and bool((diff > rtol * want[fin].abs()).any()):
        fail(f"{name}: kernel differs from its twin beyond rtol {rtol} "
             f"(max abs err {err})")
    return err


def float_words(rng, shape) -> np.ndarray:
    """:func:`u32_words` with all-zero and single-bit words mixed in: real
    slices are sparse, and these take the kernels' skip-free adds through
    empty and one-bit rows and columns."""
    w = u32_words(rng, shape).view(np.uint32)
    flat = w.reshape(-1)
    flat[5::13] = 0
    flat[2::17] = np.uint32(1) << rng.integers(0, 32, flat[2::17].size,
                                                dtype=np.uint32)
    return w.view(np.int32)


def float_values(rng, shape) -> np.ndarray:
    """Values in [0, 1) with -0.0 and subnormals mixed in, and one +inf in
    each of three VSSs (the first, middle and last of the leading axis)
    when there are 16 or more: few enough that almost every sum stays
    finite, so the exact comparison still sees the adds.  No -inf, so no
    sum is NaN and exact equality is defined."""
    v = rng.random(shape, dtype=np.float32)
    flat = v.reshape(-1)
    flat[::9] = -0.0
    flat[6::29] = np.float32(1e-40) * rng.random(flat[6::29].size,
                                                 dtype=np.float32)
    if shape[0] >= 16:
        per = v.reshape(shape[0], -1)
        for b in (0, shape[0] // 2, shape[0] - 1):
            per[b, rng.integers(per.shape[1])] = np.inf
    return v


def check_bits(torch, name: str, got, want) -> float:
    """Fail unless the float kernel output equals its twin bit for bit
    (-0.0 against +0.0 counts as a difference); return 0.0.  A case whose
    twin gives less than 90% finite outputs fails too: +inf against +inf
    would say nothing of the adds."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}, twin "
             f"{want.dtype} {tuple(want.shape)}")
    finite = float(torch.isfinite(want).float().mean()) if want.numel() \
        else 1.0
    if finite < 0.9:
        fail(f"{name}: only {finite:.3f} of the twin's outputs are finite")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fin = torch.isfinite(want) & torch.isfinite(got)
        diff = (got[fin] - want[fin]).abs()
        fail(f"{name}: kernel differs from its twin at "
             f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())}"
             f" entries (max abs err over finite entries "
             f"{float(diff.max()) if diff.numel() else 0.0})")
    return 0.0


def float_tile_bytes(kind: str, B: int, S: int, sigma: int) -> int:
    """Bytes each float tile must move: every input read once, every output
    written once (mask words, then values; the min-plus tile also reads its
    weight-plane rows)."""
    tau = 32 * (32 // sigma)
    if kind == "bvss_spmm_w":
        return B * 128 + B * sigma * S * 4 + B * tau * S * 4
    if kind == "bvss_spmm_t":
        return B * 128 + B * tau * S * 4 + B * sigma * S * 4
    return B * 128 + B * tau * sigma * 4 + B * sigma * S * 4 + B * tau * S * 4


def phase_float_kernels(torch) -> dict:
    """bvss_spmm_w, bvss_spmm_t and bvss_spmm_minplus against their twins
    on ragged cases, then timed at the rmat(18) shapes (B = 38,852 VSSs,
    S = 8 slots; bvss_spmm_w also at S = 1, PageRank's shape)."""
    from repro_torch.kernels import (bvss_spmm_minplus, bvss_spmm_t,
                                     bvss_spmm_w)
    from repro_torch.kernels.ref import (bvss_spmm_minplus_ref,
                                         bvss_spmm_t_ref, bvss_spmm_w_ref)
    rng = np.random.default_rng(SEED + 1)
    cuda = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    def view(a, off):
        """``a`` on the card at storage offset ``off`` floats: off = 1 puts
        its rows off 16-byte alignment (the kernels' 4-byte paths)."""
        flat = t(np.concatenate([np.zeros(off, np.float32), a.reshape(-1)]))
        return flat[off:].view(a.shape)

    checked, errs = 0, {"bvss_spmm_w": 0.0, "bvss_spmm_t": 0.0,
                        "bvss_spmm_minplus": 0.0}
    for sigma in SIGMAS:
        spw = 32 // sigma
        # every path of both tiles: around a block's 8 VSSs in B; S = 1
        # (PageRank), the 16-byte paths (S in {4, ..., 128}), the scalar
        # ones (S = 2, 3, 9 and rows off alignment) and the column tiles
        # of bvss_spmm_t (S > sigma)
        cases = [(B, S, 0) for B in (1, 7, 8, 9, 127, 1003)
                 for S in (1, 2, 3, 4, 8, 9, 16, 32, 128)]
        cases += [(1003, S, 1) for S in (3, 4, 8, 16)]
        for B, S, off in cases:
            tag = f"sigma={sigma} B={B} S={S} offset={off}"
            m = t(float_words(rng, (B, 32)))
            x = view(float_values(rng, (B, sigma, S)), off)
            h = view(float_values(rng, (B, spw, 32, S)), off)
            errs["bvss_spmm_w"] = max(errs["bvss_spmm_w"], check_bits(
                torch, f"bvss_spmm_w {tag}", bvss_spmm_w(m, x, sigma=sigma),
                bvss_spmm_w_ref(m, x, sigma)))
            errs["bvss_spmm_t"] = max(errs["bvss_spmm_t"], check_bits(
                torch, f"bvss_spmm_t {tag}", bvss_spmm_t(m, h, sigma=sigma),
                bvss_spmm_t_ref(m, h, sigma)))
            checked += 2
        # the min-plus tile keeps its own cases
        for B in (1, 127, 1003):
            for S in (1, 3, 8, 9):
                w = rng.uniform(0.5, 4.0, (B, spw, 32, sigma)).astype(
                    np.float32)
                w[rng.random(w.shape) < 0.2] = np.inf
                d = rng.uniform(0.0, 9.0, (B, sigma, S)).astype(np.float32)
                d[rng.random(d.shape) < 0.3] = np.inf
                m, w, d = t(u32_words(rng, (B, 32))), t(w), t(d)
                errs["bvss_spmm_minplus"] = max(
                    errs["bvss_spmm_minplus"], check_close(
                        torch, f"bvss_spmm_minplus sigma={sigma} B={B} S={S}",
                        bvss_spmm_minplus(m, w, d, sigma=sigma),
                        bvss_spmm_minplus_ref(m, w, d, sigma), 0.0))
                checked += 1
    torch.cuda.synchronize()

    # --- timing at the rmat(18) shapes, sigma = 8 ---
    sigma, B, spw = 8, RMAT18_VSS, 4
    tau = 32 * spw
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # bmm in full f32

    def unpacked(m):
        """(B, τ, σ) f32 {0,1} tile of the mask words: bmm's operand."""
        shifts = (torch.arange(spw, device=cuda) * sigma)[:, None, None]
        bits = torch.arange(sigma, device=cuda)
        words = m.to(torch.int64) & 0xFFFFFFFF
        a = (words[:, None, :, None] >> (shifts + bits)) & 1
        return a.reshape(B, tau, sigma).to(torch.float32)

    out = {}
    for name, S in (("bvss_spmm_w", SPMM_S), ("bvss_spmm_w_s1", 1),
                    ("bvss_spmm_t", SPMM_S), ("bvss_spmm_minplus", SPMM_S)):
        kind = name.replace("_s1", "")
        nbytes = float_tile_bytes(kind, B, S, sigma)
        if kind == "bvss_spmm_w":
            ins = rotating(lambda i: (t(u32_words(rng, (B, 32))), t(
                rng.random((B, sigma, S), dtype=np.float32))), nbytes)
            kern = lambda m, x: bvss_spmm_w(m, x, sigma=sigma)   # noqa: E731
            twin = lambda m, x: bvss_spmm_w_ref(m, x, sigma)      # noqa: E731
            lib = lambda m, x, a: torch.bmm(a, x)                 # noqa: E731
        elif kind == "bvss_spmm_t":
            ins = rotating(lambda i: (t(u32_words(rng, (B, 32))), t(
                rng.random((B, spw, 32, S), dtype=np.float32))), nbytes)
            kern = lambda m, h: bvss_spmm_t(m, h, sigma=sigma)   # noqa: E731
            twin = lambda m, h: bvss_spmm_t_ref(m, h, sigma)      # noqa: E731
            lib = lambda m, h, a: torch.bmm(                      # noqa: E731
                a.transpose(1, 2), h.view(B, tau, S))
        else:
            ins = rotating(lambda i: (
                t(u32_words(rng, (B, 32))),
                t(rng.uniform(0.5, 4.0, (B, spw, 32, sigma)
                              ).astype(np.float32)),
                t(rng.uniform(0.0, 9.0, (B, sigma, S)).astype(np.float32))),
                nbytes)
            kern = lambda m, w, d: bvss_spmm_minplus(      # noqa: E731
                m, w, d, sigma=sigma)
            twin = lambda m, w, d: bvss_spmm_minplus_ref(  # noqa: E731
                m, w, d, sigma)
            lib = None
        if lib is None:
            err = check_close(torch, f"{name} timed", kern(*ins[0]),
                              twin(*ins[0]), 0.0)
        else:
            err = check_bits(torch, f"{name} timed", kern(*ins[0]),
                             twin(*ins[0]))
        row = dict(shape={"B": B, "S": S, "sigma": sigma}, max_abs_err=err,
                   ms=device_ms(torch, kern, ins),
                   plain_ms=device_ms(torch, twin, ins),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   library_ms=None)
        row["share"] = row["bound_ms"] / row["ms"]
        if lib is not None:
            lib_in = [(*inp, unpacked(inp[0])) for inp in ins[:1]]
            lib_out = lib(*lib_in[0]).reshape(kern(*ins[0]).shape)
            row["library_err"] = check_close(
                torch, f"{name} bmm", lib_out, twin(*ins[0]), 1e-4)
            row["library_ms"] = device_ms(torch, lib, lib_in)
            del lib_in, lib_out
        out[name] = row
        del ins
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    emit({"phase": "float_kernels_vs_twins", "cases_checked": checked,
          "max_abs_err": errs,
          "tolerance": "bvss_spmm_w, bvss_spmm_t bit for bit; "
                       "bvss_spmm_minplus exact", **out})
    return out


def real_mask_timing(torch, masks, card: str) -> dict:
    """``bvss_spmm_w`` (S = 8 and S = 1) and ``bvss_spmm_t`` (S = 8) timed a
    second time on a prepared graph's own mask words (all its VSSs, the
    dummy row excluded) against random values, each equal to its twin bit
    for bit; -> {kernel: row} beside the random-word rows.  Each rotated
    input holds its own copy of the words, so they too are read past L2,
    as the bound counts them.  Real slices are sparse where random words
    set half the bits."""
    from repro_torch.kernels import bvss_spmm_t, bvss_spmm_w
    from repro_torch.kernels.ref import bvss_spmm_t_ref, bvss_spmm_w_ref
    rng = np.random.default_rng(SEED + 2)
    sigma, spw = 8, 4
    B = masks.shape[0]
    cuda = masks.device
    out = {}
    for name, S in (("bvss_spmm_w", SPMM_S), ("bvss_spmm_w_s1", 1),
                    ("bvss_spmm_t", SPMM_S)):
        kind = name.replace("_s1", "")
        nbytes = float_tile_bytes(kind, B, S, sigma)
        shape = (B, sigma, S) if kind == "bvss_spmm_w" else (B, spw, 32, S)
        ins = rotating(lambda i: (masks.clone(), torch.from_numpy(
            rng.random(shape, dtype=np.float32)).to(cuda)), nbytes)
        kern = (bvss_spmm_w if kind == "bvss_spmm_w" else bvss_spmm_t)
        twin = (bvss_spmm_w_ref if kind == "bvss_spmm_w" else bvss_spmm_t_ref)
        err = check_bits(torch, f"{name} real masks",
                         kern(*ins[0], sigma=sigma), twin(*ins[0], sigma))
        ms = device_ms(torch, lambda m, v: kern(m, v, sigma=sigma), ins)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(shape={"B": B, "S": S, "sigma": sigma},
                         max_abs_err=err, ms=ms, bound_ms=bound,
                         share=bound / ms)
        del ins
    words = masks.to(torch.int64) & 0xFFFFFFFF
    bits = int(sum(int(((words >> b) & 1).sum()) for b in range(32)))
    emit({"phase": "float_kernels_real_masks", "num_vss": B,
          "set_bit_share": bits / (B * 32 * 32), **out, "card": card})
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


def device_spans(prof) -> tuple[float, list]:
    """The device's busy time in a torch.profiler trace, in us (the union
    of its kernel and copy intervals), and those intervals as sorted
    ``(start, end, name)``."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us, spans


def device_busy_ms(torch, fn, inputs: list) -> float:
    """Device busy time of one ``fn(*inp)`` call, in ms: torch.profiler
    over one pass of ``inputs`` after a warm pass, busy time over calls.
    Unlike CUDA events around queued calls it leaves out the time the
    device waits for the host, which a composition of many small
    operations cannot hide."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for inp in inputs:
        fn(*inp)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for inp in inputs:
            fn(*inp)
        torch.cuda.synchronize()
    return device_spans(prof)[0] / 1e3 / len(inputs)


def profile(torch, run, name: str, card: str, **extra) -> None:
    """Where one run's time goes on the card: ``torch.profiler`` over
    ``run()`` after one warm run.  Prints the wall time, the device's busy
    time (the union of its kernel and copy intervals) and idle share, and
    the device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    run()                                       # warm: allocator, libraries
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, spans = device_spans(prof)
    by_name: dict = {}
    for a, b, kname in spans:
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


def require_push_levels(counts: dict, phase: str) -> None:
    """A single-source BVSS phase sweeps once a level and pulls once a pull
    level, so its push levels are the sweeps less the pulls: each must be
    one bvss_push_level launch, and the unfused bvss_push must not run."""
    push_levels = counts["finalize_pack_sweep"] - counts["bvss_pull"]
    if counts["bvss_push_level"] != push_levels or counts["bvss_push"]:
        fail(f"{phase}: {push_levels} push levels but "
             f"{counts['bvss_push_level']} bvss_push_level and "
             f"{counts['bvss_push']} bvss_push launches")


def session_phase(torch, rt, name: str, g, sources, card: str, oracle,
                  kernels: tuple, weights=None):
    """Build ``GraphSession(g, max_batch=SLOTS, weights=weights)`` and
    serve single-source ``levels`` queries against the oracle."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    sess = rt.GraphSession(g, max_batch=SLOTS, weights=weights)
    p = sess.prepared
    reset_launch_counts()
    rows = run_sources(torch, g, sess.levels, sources, oracle)
    counts = launch_counts()
    require_launches(counts, name, kernels)
    require_push_levels(counts, name)
    emit({"phase": name, "n": g.n, "m": g.m, "ordering": p.ordering,
          "engine": p.engine_name, "sigma": p.bvss.sigma,
          "num_vss": p.bvss.num_vss,
          "max_vss_per_set": p.bvss.max_vss_per_set,
          "prepare_s": sess.preprocess_s, "sources": rows,
          "launches": counts, "card": card})
    return sess, counts, rows


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
    # the refill rounds of components(), bounded: the first seeds outside
    # the largest component flood through the session's symmetrised wave
    # pool, one per freed slot (the whole verb is 2,356 rounds)
    from repro_torch.core.multi_source import drive_wave
    seeds = sess.perm[np.flatnonzero(want != big)[:COMPONENTS_PROFILE_SEEDS]]

    def refill_rounds():
        it = iter(seeds.tolist())
        return drive_wave(sess._sym_ms(), lambda slot: next(it, None),
                          lambda slot, levels: None)

    profile(torch, refill_rounds, "components_rmat_16", card,
            refill_seeds=len(seeds), rounds=refill_rounds())
    return counts


def betweenness_phase(torch, sess, g, sources, card: str) -> dict:
    """``betweenness_batch`` of one cohort against the float64 Brandes
    oracle, at the reference tests' rtol 1e-4, atol 1e-4."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import betweenness_ref
    f = sess._bc_fn(len(sources))
    eng, before = f.engine, dict(f.engine.stats)
    bwd_before = dict(f.stats)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bc = sess.betweenness_batch(sources)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    require_launches(counts, "betweenness_batch",
                     ("bvss_spmm", "bvss_spmm_w", "bvss_spmm_t"))
    t0 = time.perf_counter()
    want = betweenness_ref(g, sources)
    oracle_s = time.perf_counter() - t0
    err = np.abs(bc - want)
    if bc.shape != want.shape or not np.all(np.isfinite(bc)) or \
            bool((err > 1e-4 + 1e-4 * np.abs(want)).any()):
        fail(f"betweenness_batch differs from betweenness_ref (max abs "
             f"err {float(err.max())})")
    fwd = {k: eng.stats[k] - before[k] for k in eng.stats}
    emit({"phase": "betweenness_rmat_18", "sources": len(sources),
          "wall_ms": wall_s * 1e3, "oracle_s": oracle_s,
          "forward_levels": fwd["pull_levels"] + fwd["push_levels"],
          "backward_levels": f.stats["backward_levels"]
          - bwd_before["backward_levels"],
          "host_syncs": fwd["host_syncs"] + f.stats["host_syncs"]
          - bwd_before["host_syncs"],
          "max_abs_err": float(err.max()),
          "max_rel_err": float(np.max(err / np.maximum(np.abs(want),
                                                        1e-300))),
          "max_score": float(want.max()),
          "tolerance": "rtol 1e-4, atol 1e-4", "launches": counts,
          "card": card})
    # the cohort's device busy and the float tiles' share of it: both
    # Brandes phases, the hrows[row_ids] gather of the backward sweep too
    internal = sess.perm[np.asarray(sources)]
    profile(torch, lambda: f(internal), "betweenness_rmat_18", card,
            sources=len(sources))
    return counts


def sssp_phase(torch, rt, sess, g, sources, card: str, name: str,
               weights) -> dict:
    """``sssp_batch`` of one cohort and ``sssp(src)`` against SciPy's
    Dijkstra, exactly (``weights`` None: unit weights, the BFS levels)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import sssp_ref
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = sess.sssp_batch(sources)
    batch_s = time.perf_counter() - t0
    f = sess._sssp_fn(len(sources))
    batch_stats = dict(f.stats)
    single_s = None
    if weights is not None:
        t0 = time.perf_counter()
        one = sess.sssp(sources[1])
        single_s = time.perf_counter() - t0
    counts = launch_counts()
    require_launches(counts, name, ("bvss_spmm_minplus",))
    t0 = time.perf_counter()
    if weights is None:
        want = np.stack([np.where(lv == INF, np.inf, lv).astype(np.float64)
                         for lv in (rt.reference_bfs(g, s)
                                    for s in sources)])
    else:
        want = sssp_ref(g, sources, weights)
    oracle_s = time.perf_counter() - t0
    if dist.shape != want.shape or not np.array_equal(dist, want):
        bad = int(np.count_nonzero(dist != want))
        fail(f"{name}: sssp_batch differs from the oracle at {bad} entries")
    if weights is not None and not np.array_equal(one, want[1]):
        fail(f"{name}: sssp(src) differs from Dijkstra")
    emit({"phase": name, "sources": len(sources),
          "batch_wall_ms": batch_s * 1e3,
          "single_wall_ms": None if single_s is None else single_s * 1e3,
          "oracle_s": oracle_s, "batch_stats": batch_stats,
          "single_stats": None if single_s is None
          else dict(sess._sssp_fn(1).stats),
          "reached": int(np.isfinite(want).sum()),
          "max_dist": float(want[np.isfinite(want)].max()),
          "tolerance": "exact", "launches": counts, "card": card})
    return counts


def pagerank_phase(torch, sess, g, card: str) -> dict:
    """``pagerank()`` against the float64 power iteration ``pagerank_ref``.
    Tolerance: relative error 1e-4 per vertex at this size (float32 sums
    over in-degrees up to the thousands, each iteration, amplified by
    1/(1-d)), and the scores' sum within 1e-5 of 1."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import pagerank_ref
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr = sess.pagerank()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    require_launches(counts, "pagerank", ("bvss_spmm_w",))
    t0 = time.perf_counter()
    want = pagerank_ref(g)
    oracle_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(pr - want) / want))
    total = float(pr.sum())
    if pr.shape != want.shape or not rel <= 1e-4 or \
            not abs(total - 1.0) <= 1e-5:
        fail(f"pagerank differs from pagerank_ref (max rel err {rel}, sum "
             f"{total})")
    fn = next(v for k, v in sess._analytics_cache.items()
              if isinstance(k, tuple) and k[0] == "pagerank_fn")
    first = dict(fn.stats)
    again = sess.pagerank()          # the card's atomics: same answer?
    emit({"phase": "pagerank_rmat_18", "wall_ms": wall_s * 1e3,
          "oracle_s": oracle_s, "iterations": first["iterations"],
          "host_syncs": first["host_syncs"],
          "iterations_again": fn.stats["iterations"] - first["iterations"],
          "bitwise_equal_runs": bool(np.array_equal(pr, again)),
          "max_rel_err": rel, "l1_err": float(np.abs(pr - want).sum()),
          "sum": total, "tolerance": "rel err 1e-4, |sum - 1| 1e-5",
          "launches": counts, "card": card})
    profile(torch, fn, "pagerank_rmat_18", card)
    return counts


def table2_phase(torch, rt, name: str, g, card: str, rng, ordered=None,
                 profiled: tuple = (), push_row: dict | None = None
                 ) -> dict:
    """The paper's Table-2 matrix on ``g``: every variant of
    ``repro_torch.launch.bfs.ENGINE_VARIANTS``, one warm BFS then
    TABLE2_SOURCES timed ones (sources with out-edges), each equal to the
    oracle; ms per BFS, levels and speedup against ``brs``.  ``ordered``
    is an ordered BVSS preparation of ``g`` to reuse.  The unordered
    variants named in ``profiled`` are then profiled over their first
    TABLE2_PROFILE_LEVELS levels from the first source.  With
    ``push_row``, bvss_push_level is timed at this graph's push levels
    (``blest_full``'s problem, the first source's BFS) into
    ``push_row[name]``."""
    from repro_torch.bench.table2_bfs import variant_engines
    from repro_torch.core.bfs import (make_blest_bfs, make_brs_bfs,
                                      make_csr_bfs)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    sources = [int(s) for s in rng.choice(np.flatnonzero(g.out_degree > 0),
                                          TABLE2_SOURCES, replace=False)]
    oracle = memo_oracle(rt)
    t0 = time.perf_counter()
    variants = variant_engines(g, device="cuda", ordered=ordered)
    build_s = time.perf_counter() - t0
    rows, total = {}, {}
    for vname, v in variants.items():
        reset_launch_counts()
        v.levels(sources[0])                    # warm: allocator
        runs = run_sources(torch, g, v.levels, sources, oracle)
        counts = launch_counts()
        if vname == "brs":
            require_launches(counts, f"{name} {vname}", ("bvss_pull",))
        elif vname.startswith("blest"):
            require_launches(counts, f"{name} {vname}",
                             ("bvss_pull", "finalize_pack_sweep"))
        require_push_levels(counts, f"{name} {vname}")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        rows[vname] = {"engine": v.core,
                       "ms_per_bfs": statistics.median(
                           r["bfs_ms"] for r in runs),
                       "levels": [r["levels_run"] for r in runs],
                       "bfs_ms": [r["bfs_ms"] for r in runs],
                       "launches": counts}
    for row in rows.values():
        row["speedup_vs_brs"] = rows["brs"]["ms_per_bfs"] / row["ms_per_bfs"]
    emit({"phase": name, "n": g.n, "m": g.m, "sources": sources,
          "ordering": variants["blest_full"].ordering,
          "variant_build_s": build_s, "variants": rows,
          "oracle": "equal to reference_bfs", "card": card})
    cap = TABLE2_PROFILE_LEVELS
    for vname in profiled:
        problem = variants[vname].problem
        fn = {"brs": lambda: make_brs_bfs(problem, max_levels=cap),
              "blest_a": lambda: make_blest_bfs(problem, lazy=False,
                                                max_levels=cap),
              "csr_push": lambda: make_csr_bfs(g, "push", max_levels=cap,
                                               device="cuda")}[vname]()
        profile(torch, lambda: fn(sources[0]), f"{name}_{vname}", card,
                levels_cap=cap)
    if push_row is not None:
        v = variants["blest_full"]
        lv = np.empty(g.n, np.int32)
        lv[v.perm] = oracle(g, sources[0])
        push_row[name] = push_level_timing(torch, v.problem, lv, name, card)
    return total


def bit_spmm_twin_chunked(a, x, rows: int = 2048):
    """bit_spmm_ref over row chunks: the twin unpacks A densely, 17.2 GB at
    R = C = 65,536 in one piece."""
    import torch
    from repro_torch.kernels.ref import bit_spmm_ref
    return torch.cat([bit_spmm_ref(a[i:i + rows], x)
                      for i in range(0, a.shape[0], rows)])


def dense_phase(torch, rt, sess, g, rng, card: str) -> tuple[dict, dict]:
    """The dense multi-source baseline on ``g``: the ``to_dense_bits``
    adjacency, ``make_dense_multi_source_bfs`` (``bit_spmm`` a level)
    against the BVSS engine on the session's preparation, both equal to
    each other and to the oracle; ``dense_pull`` from one source; then
    ``bit_spmm`` timed at this shape against its twin and ``torch._int_mm``
    over the unpacked int8 adjacency."""
    from repro_torch.bench.bench_service import make_dense_multi_source_bfs
    from repro_torch.core.bfs import make_engine
    from repro_torch.core.multi_source import make_multi_source_bfs
    from repro_torch.graphs import to_dense_bits
    from repro_torch.kernels import (bit_spmm, launch_counts,
                                     reset_launch_counts)
    cuda = torch.device("cuda")
    t0 = time.perf_counter()
    A = to_dense_bits(g)
    dense_build_s = time.perf_counter() - t0
    srcs = np.asarray(rng.choice(g.n, SLOTS, replace=False))
    p = sess.prepared
    f_dense = make_dense_multi_source_bfs(g, SLOTS)
    f_bvss = make_multi_source_bfs(None, SLOTS, problem=p.problem)
    internal = p.perm[srcs]

    def timed(fn, arg):
        fn(arg)                                 # warm: allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(arg).cpu().numpy()
        return out, (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    lv_d, dense_ms = timed(f_dense, srcs)
    counts = launch_counts()
    require_launches(counts, "dense_rmat_16", ("bit_spmm",))
    lv_b, bvss_ms = timed(f_bvss, internal)
    if not np.array_equal(lv_b[p.perm], lv_d):
        fail("dense_rmat_16: dense and BVSS multi-source levels differ")
    for i, s in enumerate(srcs):
        if not np.array_equal(lv_d[:, i], rt.reference_bfs(g, int(s))):
            fail(f"dense_rmat_16: levels of source {s} differ from the "
                 f"oracle")
    f_pull = make_engine(g, "dense_pull")
    pull_lv, pull_ms = timed(f_pull, int(srcs[0]))
    if not np.array_equal(pull_lv, rt.reference_bfs(g, int(srcs[0]))):
        fail("dense_rmat_16: dense_pull differs from the oracle")
    levels_run = int(lv_d[lv_d != INF].max()) + 1
    emit({"phase": "dense_rmat_16", "n": g.n, "m": g.m, "sources": SLOTS,
          "to_dense_bits_s": dense_build_s,
          "dense_adjacency_bytes": int(A.nbytes),
          "bvss_static_bytes": int(p.bvss.memory_bytes()["bvss"]),
          "dense_multi_source_ms": dense_ms, "bvss_multi_source_ms": bvss_ms,
          "dense_vs_bvss": dense_ms / bvss_ms, "levels_run": levels_run,
          "dense_pull_ms": pull_ms, "oracle": "equal to reference_bfs",
          "launches": counts, "card": card})

    # bit_spmm at this shape: the adjacency against S = 8 {0,1} columns
    a = torch.from_numpy(A).to(cuda)
    del A
    x = torch.from_numpy(rng.integers(0, 2, (g.n, SLOTS)).astype(
        np.int8)).to(cuda)
    want = bit_spmm_twin_chunked(a, x)
    err = check_equal(torch, "bit_spmm timed", bit_spmm(a, x), want)
    nbytes = a.numel() * 4 + x.numel() + g.n * SLOTS * 4
    row = dict(shape={"R": g.n, "C": g.n, "S": SLOTS,
                      "set_bits": int(g.m)}, max_abs_err=err,
               ms=device_ms(torch, bit_spmm, [(a, x)]),
               plain_ms=device_ms(torch, bit_spmm_twin_chunked, [(a, x)],
                                  reps=1),
               plain_shape="bit_spmm_ref in row chunks of 2,048",
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    # the library call: int8 x int8 -> int32 over the unpacked adjacency
    # (4.29 GB, its unpacking not timed)
    shifts = torch.arange(32, dtype=torch.int32, device=cuda)
    a8 = torch.empty((g.n, a.shape[1] * 32), dtype=torch.int8, device=cuda)
    for i in range(0, g.n, 4096):
        a8[i:i + 4096] = ((a[i:i + 4096, :, None] >> shifts) & 1).reshape(
            -1, a.shape[1] * 32).to(torch.int8)
    xt = x.t().contiguous().t()        # column-major X: cuBLASLt's fast case
    lib = torch._int_mm(a8, xt)
    row["library_err"] = check_equal(torch, "bit_spmm torch._int_mm", lib,
                                     want)
    row["library_ms"] = device_ms(torch, torch._int_mm, [(a8, xt)], reps=5)
    row["library_shape"] = ("unpacked int8 A (65,536 x 65,536) against "
                            "column-major X, unpack excluded")
    del a8, lib, a, want
    torch.cuda.empty_cache()
    return counts, row


def kernel_bench_phase(torch, card: str) -> dict:
    """``repro_torch.bench.kernel_bench.run()`` on the card: the path of
    ``finalize_sweep``, timed beside the fused lazy sweep."""
    from repro_torch.bench import kernel_bench
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    rows = kernel_bench.run("cuda", verbose=False)
    counts = launch_counts()
    require_launches(counts, "kernel_bench",
                     ("finalize_sweep", "bit_spmm", "bvss_pull",
                      "finalize_pack_sweep"))
    emit({"phase": "kernel_bench", "rows": rows,
          "timing": "host clock around one launch and a synchronise",
          "launches": counts, "card": card})
    return counts


def cli_phase(torch, card: str) -> dict:
    """``python -m repro_torch.launch.bfs`` for every variant, in process,
    on the card (its default device): each must end ``VERIFIED vs
    oracle``."""
    import contextlib
    import io
    from repro_torch.launch import bfs as launcher
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    last = {}
    for variant in sorted(launcher.ENGINE_VARIANTS):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launcher.main(["--graph", "road", "--scale", str(CLI_SCALE),
                           "--engine", variant, "--sources", "2"])
        line = buf.getvalue().strip().splitlines()[-1]
        if not line.endswith("VERIFIED vs oracle"):
            fail(f"launcher {variant}: {line}")
        last[variant] = line
    emit({"phase": "launch_cli", "graph": f"road, scale {CLI_SCALE}",
          "last_lines": last, "launches": launch_counts(), "card": card})
    return launch_counts()


# ---------------------------------------------------------------------------
# phase 8: the analytics launcher, the paper's other tables, Figure 3, the
# RMAT scale sweep and the analytics bench
# ---------------------------------------------------------------------------
# cut from rmat(16), where extremes() alone took 74.6 s (PERF.md), to make
# room for phase 10 within the script's time limit
ANALYTICS_ARGS = ["--graph", "rmat", "--scale", "14", "--sources", "8",
                  "--max-batch", "8", "--verify"]
FIG3_SCALE = 14                  # clustered(256, 64); cut from 16 (PERF.md)
SCALE_SWEEP = (14, 16, 18)       # the RMAT scale sweep's scales
ANALYTICS_BENCH_SCALE = 12       # bench_analytics' graph suite scale


def bench_call(fn, *args, **kwargs):
    """Run a bench of the port; a check it fails becomes :func:`fail`."""
    from repro_torch.errors import KernelFaultError
    try:
        return fn(*args, **kwargs)
    except KernelFaultError as e:
        fail(f"{fn.__module__}: {e}")


def analytics_cli_phase(torch, card: str) -> dict:
    """``python -m repro_torch.launch.analytics`` in process, on the card
    (its default device), every verb of ``WHAT`` on rmat(14): each checked
    verb must end in its ``VERIFIED`` suffix, through the four tiles."""
    import contextlib
    import io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import analytics
    reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_call(analytics.main,
                   ANALYTICS_ARGS + ["--what", ",".join(analytics.WHAT)])
    counts = launch_counts()
    lines = buf.getvalue().strip().splitlines()
    verbs = {}
    for line in lines[1:]:
        verb = line.removeprefix("[analytics] ").split(":")[0].split(" ")[0]
        verbs[verb] = line
    if list(verbs) != list(analytics.WHAT):
        fail(f"launch_analytics printed {list(verbs)}: {lines}")
    for verb, line in verbs.items():
        if verb != "extremes" and "; VERIFIED vs " not in line:
            fail(f"launch_analytics {verb}: {line}")
    require_launches(counts, "launch_analytics",
                     ("bvss_spmm", "bvss_spmm_w", "bvss_spmm_t",
                      "bvss_spmm_minplus"))
    emit({"phase": "launch_analytics", "args": ANALYTICS_ARGS,
          "first_line": lines[0], "verbs": verbs, "launches": counts,
          "card": card})
    return counts


def paper_tables_phase(torch, card: str) -> dict:
    """Tables 1a, 1b and 4 at the reference's default sizes: host
    statistics, each derived column equal to the JAX package's row
    (:data:`PAPER_TABLE_DERIVED`); the time column is this host's."""
    from repro_torch.bench import (table1a_compression, table1b_divergence,
                                   table4_footprint)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    rows = (table1a_compression.run(verbose=False)
            + table1b_divergence.run(verbose=False)
            + table4_footprint.run(verbose=False))
    counts = launch_counts()
    got = {}
    host_us = {}
    for r in rows:
        name, us, rest = r.split(",", 2)
        got[name], host_us[name] = rest, float(us)
    if got != PAPER_TABLE_DERIVED:
        bad = sorted(k for k in set(got) | set(PAPER_TABLE_DERIVED)
                     if got.get(k) != PAPER_TABLE_DERIVED.get(k))
        fail(f"paper_tables_host: rows differ from the reference's: "
             f"{[(k, got.get(k), PAPER_TABLE_DERIVED.get(k)) for k in bad]}")
    emit({"phase": "paper_tables_host", "rows": got,
          "host_us": host_us, "tolerance": "derived columns equal",
          "launches": counts, "card": card})
    return counts


def fig3_phase(torch, card: str) -> dict:
    """Figure 3 on the card: for each window w = 8 ... 4096 the
    compression and the ms per BFS of ``clustered`` under
    ``jaccard_windows(w)``, every timed BFS held against
    ``reference_bfs``."""
    from repro_torch.bench import fig3_window
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    rows = bench_call(fig3_window.run, scale=FIG3_SCALE, verbose=False)
    counts = launch_counts()
    require_launches(counts, "fig3_clustered_16",
                     ("bvss_pull", "finalize_pack_sweep"))
    windows = []
    for r in rows:
        name, us, rest = r.split(",", 2)
        windows.append({"w": int(name.split("=")[1]),
                        "compression": float(rest.split("=")[1]),
                        "ms_per_bfs": float(us) / 1e3})
    if [w["w"] for w in windows] != [1 << k for k in range(3, 13)
                                     if 1 << k <= 1 << FIG3_SCALE]:
        fail(f"fig3: windows {[w['w'] for w in windows]}")
    emit({"phase": "fig3_clustered_16",
          "graph": f"clustered({(1 << FIG3_SCALE) // 64}, 64)",
          "n": 1 << FIG3_SCALE, "windows": windows,
          "reduced": {"scale": [16, FIG3_SCALE],
                      "why": "jaccard_windows' host loop: 10-11 s a window "
                             "at n = 65,536 on the card machine's host, "
                             "about 100 s for ten (PERF.md section 4)"},
          "launches": counts, "card": card})
    return counts


def scale_phase(torch, card: str) -> dict:
    """The RMAT scale sweep, one ``bench_scale.run`` a scale (each held
    against the oracle first): MTEPS, the ``memory_bytes`` model and, beside
    it, the card's own peak of allocated memory over the scale's
    ``prepare`` and BFSs."""
    from repro_torch.bench import bench_scale
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    scales = {}
    for sc in SCALE_SWEEP:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = bench_call(bench_scale.run, scales=(sc,), verbose=False)
        wall = time.perf_counter() - t0
        row = out["scales"][str(sc)]
        if not out["summary"]["all_verified"]:
            fail(f"bench_scale rmat({sc}) not verified")
        scales[str(sc)] = {
            **row, "wall_s": wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "allocated_before": base}
    counts = launch_counts()
    require_launches(counts, "bench_scale_rmat",
                     ("bvss_pull", "finalize_pack_sweep"))
    emit({"phase": "bench_scale_rmat", "scales": scales,
          "launches": counts, "card": card})
    return counts


def analytics_bench_phase(torch, card: str) -> dict:
    """``repro_torch.bench.bench_analytics.run`` on the card: the wave verbs
    against sequential single-source BFSs and the oracles, every check of
    the reference bench passing."""
    from repro_torch.bench import bench_analytics
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = bench_call(bench_analytics.run, scale=ANALYTICS_BENCH_SCALE,
                     n_queries=8, n_pivots=4, verbose=False)
    counts = launch_counts()
    if out["summary"]["all_verified"] is not True:
        fail(f"bench_analytics: not all verified: {out['summary']}")
    require_launches(counts, "bench_analytics",
                     ("bvss_pull", "finalize_pack_sweep", "bvss_spmm",
                      "bvss_spmm_w", "bvss_spmm_t", "bvss_spmm_minplus"))
    emit({"phase": "bench_analytics", "scale": ANALYTICS_BENCH_SCALE,
          "summary": out["summary"], "graphs": out["graphs"],
          "launches": counts, "card": card})
    return counts


# ---------------------------------------------------------------------------
# phase 9: the hardened serving tier — the manager, the async queue,
# deadlines, the fault gauntlet on the hand kernels, the launcher's
# --service and the two serving benches
# ---------------------------------------------------------------------------
SERVE_SCALE = 18                 # the social regime's rmat(18)
SERVE_QUERIES = 3 * SLOTS        # 24 sources through the 8 slots
DEADLINE_SIDE = 512              # grid2d(512, 512): 1,023 levels a corner
DEADLINE_S = 0.2                 # harvests mid-flight at a few hundred
FAULT_SCALE = 16                 # the verbs phase's rmat(16)
FAULT_QUERIES = 4
SERVICE_ARGS = ["--graph", "road", "--scale", "16", "--engine",
                "blest_full", "--sources", "8", "--service", "--max-batch",
                "8", "--queue", "--verify-fraction", "1.0"]
SERVE_BENCH_SCALE = 9            # bench_service's and bench_queue's default


def check_levels(phase: str, g, sources, got, oracle) -> None:
    """Every answer a full level array equal to the oracle's."""
    for s, lv in zip(sources, got):
        want = oracle(g, s)
        if not isinstance(lv, np.ndarray) or lv.dtype != want.dtype or \
                not np.array_equal(lv, want):
            fail(f"{phase}: the answer for source {s} differs from the "
                 f"oracle ({type(lv).__name__})")


def check_partial(phase: str, g, r, oracle, depth_max: int) -> int:
    """A deadline harvest: a TimeoutResult whose levels are the oracle's
    up to its depth, bit for bit, with ``0 < depth < depth_max``."""
    from repro_torch.serve import TimeoutResult
    if not isinstance(r, TimeoutResult):
        fail(f"{phase}: expected a TimeoutResult, got {type(r).__name__}")
    want = oracle(g, r.source)
    if not 0 < r.depth < depth_max:
        fail(f"{phase}: harvested at depth {r.depth}, outside (0, "
             f"{depth_max})")
    if not np.array_equal(r.levels, np.where(want <= r.depth, want, INF)):
        fail(f"{phase}: the partial levels of source {r.source} differ "
             f"from the oracle's up to depth {r.depth}")
    if not np.array_equal(r.frontier, np.flatnonzero(want == r.depth)):
        fail(f"{phase}: the frontier of source {r.source} at depth "
             f"{r.depth} differs from the oracle's")
    return r.depth


def serve_manager_phase(torch, rt, rng, card: str):
    """The full-width serving path: ``rmat(18)`` opened once through
    ``GraphSessionManager(verify_fraction=1.0)``; ``levels_batch`` of 24
    sources through 8 slots (every answer the oracle's and verified, no
    quarantine), ``betweenness`` and ``closeness`` of 8 through the
    manager's finite guards (against the oracles at the reference's
    tolerances), the hardened ratio (bare session against the manager with
    a deadline that never fires, verification off for the timing), the
    verify cost, and ``session_cost_bytes`` beside the card's own peaks
    (over the open and warm-up, and over the verified wave alone)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import betweenness_ref, closeness_ref
    from repro_torch.serve import session_cost_bytes
    g = rt.generators.rmat(SERVE_SCALE)
    oracle = memo_oracle(rt)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mgr = rt.GraphSessionManager(verify_fraction=1.0)
    sess = mgr.open_session("serve", g, tenant="acme", max_batch=SLOTS)
    open_s = time.perf_counter() - t0
    queries = [int(s) for s in rng.choice(g.n, SERVE_QUERIES, replace=False)]
    sess.levels_batch(queries[:2])                      # warm: allocator
    torch.cuda.synchronize()
    # the peak over open and warm-up (the ordering pass, the BVSS build),
    # then the wave's own peak; both above the memory before the open
    peak_open = torch.cuda.max_memory_allocated() - base
    before_wave = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    lvs = mgr.levels_batch("serve", queries, tenant="acme")
    verified_s = time.perf_counter() - t0
    wave_counts = launch_counts()
    torch.cuda.synchronize()
    peak_wave = torch.cuda.max_memory_allocated() - base
    resident = torch.cuda.memory_allocated() - base
    t0 = time.perf_counter()
    check_levels("serve_manager_rmat_18", g, queries, lvs, oracle)
    oracle_s = time.perf_counter() - t0
    st = mgr.stats()
    if st["verified"] != SERVE_QUERIES or st["quarantines"]:
        fail(f"serve_manager_rmat_18: {st['verified']} verified, "
             f"{st['quarantines']} quarantines: {st}")

    # the hardened ratio: the same engine bare and through the manager
    # (deadline armed, never firing); verification off for the timing, as
    # in bench_service's manager, so the ratio is the layer's own cost
    mgr.verify_fraction = 0.0
    samples = {"bare": [], "hardened": []}
    calls = {"bare": lambda: sess.levels_batch(queries),
             "hardened": lambda: mgr.levels_batch(
                 "serve", queries, tenant="acme", deadline_s=3600.0)}
    for _ in range(3):
        for key, call in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            samples[key].append(time.perf_counter() - t0)
            check_levels(f"serve_manager_rmat_18 {key}", g, queries, out,
                         oracle)
    mgr.verify_fraction = 1.0
    bare_s, hard_s = (statistics.median(samples[k])
                      for k in ("bare", "hardened"))

    # the float verbs through the manager's finite guards
    fsrcs = [int(s) for s in rng.choice(g.n, SLOTS, replace=False)]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bc = mgr.betweenness("serve", fsrcs, tenant="acme")
    bc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc = mgr.closeness("serve", fsrcs, tenant="acme")
    cc_s = time.perf_counter() - t0
    verb_counts = launch_counts()
    st = mgr.stats()
    if st["quarantines"] or st["degraded_serves"]:
        fail(f"serve_manager_rmat_18: a finite guard tripped: {st}")
    want_bc = betweenness_ref(g, fsrcs)
    bc_err = np.abs(bc - want_bc)
    if not np.all(np.isfinite(bc)) or \
            bool((bc_err > 1e-4 + 1e-4 * np.abs(want_bc)).any()):
        fail(f"serve_manager_rmat_18: betweenness differs from "
             f"betweenness_ref (max abs err {float(bc_err.max())})")
    want_cc = closeness_ref(g, fsrcs)
    cc_err = float(np.max(np.abs(cc - want_cc)
                          / np.maximum(np.abs(want_cc), 1e-300)))
    if not np.all(np.isfinite(cc)) or cc_err > 1e-12:
        fail(f"serve_manager_rmat_18: closeness differs from closeness_ref "
             f"(rel err {cc_err})")
    counts = {k: wave_counts[k] + verb_counts[k] for k in wave_counts}
    require_launches(wave_counts, "serve_manager_rmat_18 levels_batch",
                     ("bvss_spmm",))
    require_launches(verb_counts, "serve_manager_rmat_18 verbs",
                     ("bvss_spmm", "bvss_spmm_w", "bvss_spmm_t"))
    p = sess.prepared
    cost = session_cost_bytes(sess)
    emit({"phase": "serve_manager_rmat_18", "n": g.n, "m": g.m,
          "ordering": p.ordering, "engine": p.engine_name,
          "num_vss": p.bvss.num_vss, "slots": SLOTS,
          "open_session_s": open_s, "queries": SERVE_QUERIES,
          "levels_batch_verified_ms": verified_s * 1e3,
          "bare_ms": bare_s * 1e3, "hardened_ms": hard_s * 1e3,
          "bare_vs_hardened": bare_s / hard_s,
          "verify_cost_ms": (verified_s - hard_s) * 1e3,
          "smoke_oracle_s": oracle_s,
          "bare_samples_ms": [t * 1e3 for t in samples["bare"]],
          "hardened_samples_ms": [t * 1e3 for t in samples["hardened"]],
          "betweenness_ms": bc_s * 1e3,
          "betweenness_max_abs_err": float(bc_err.max()),
          "closeness_ms": cc_s * 1e3, "closeness_max_rel_err": cc_err,
          "tolerance": "levels exact; betweenness rtol 1e-4, atol 1e-4; "
                       "closeness rtol 1e-12",
          "session_cost_bytes": cost,
          "max_memory_allocated_open": peak_open,
          "max_memory_allocated_wave": peak_wave,
          "memory_allocated_before_wave": before_wave,
          "memory_allocated": resident,
          "stats": mgr.stats(), "launches": counts, "card": card})
    return mgr, g, oracle, queries, counts


def serve_queue_phase(torch, rt, mgr, g, oracle, queries, card: str):
    """A ``RequestQueue`` over the manager of the serving phase: 24
    requests from two tenants, four slots each (``max_inflight``), arriving
    with staggered ``not_before`` (exponential gaps, mean a quarter of the
    measured single-query time, as in ``bench_queue``); once through
    ``drain(wait=True)`` and once through the ``start()`` pump with the two
    tenants submitting from two threads.  A session belongs to one tenant,
    so the second tenant gets its own session over the same graph, without
    the ordering pass (its preparation is the BVSS build).  Every future
    equals the oracle, and requests coalesce into waves in flight.

    First, ``bench_queue``'s comparison at this width: the 24 requests of
    one tenant answered call at a time (``bench_queue``'s server loop)
    against one queue's ``drain(wait=True)``, under the same arrivals
    (``poisson``) and all at t = 0 (``backlog``), with verification off so
    the makespans time the card and not the host oracle; every answer is
    still held to the oracle here."""
    import threading
    from repro_torch.bench.bench_queue import serve_call_at_a_time
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import RequestQueue, TenantQuota
    sess = mgr._sessions["serve"].session
    t0 = time.perf_counter()
    for s in queries[:3]:
        sess.levels(s)
    t1 = (time.perf_counter() - t0) / 3
    rng = np.random.default_rng(SEED + 10)
    arrivals = np.cumsum(np.r_[0.0, rng.exponential(t1 / 4,
                                                    len(queries) - 1)])
    reset_launch_counts()
    mgr.verify_fraction = 0.0
    ratios = {}
    for section, arr in (("poisson", arrivals),
                         ("backlog", np.zeros(len(queries)))):
        t_call, seq = serve_call_at_a_time(sess, queries, arr)
        check_levels(f"serve_queue_rmat_18 {section} call_at_a_time", g,
                     queries, seq, oracle)
        q = RequestQueue(mgr)
        t0 = time.monotonic()
        futs = [q.submit("serve", s, tenant="acme", not_before=t0 + a)
                for s, a in zip(queries, arr)]
        q.drain(wait=True)
        t_queued = time.monotonic() - t0
        check_levels(f"serve_queue_rmat_18 {section} queued", g, queries,
                     [f.result(0) for f in futs], oracle)
        ratios[section] = {"call_at_a_time_ms": t_call * 1e3,
                           "queued_ms": t_queued * 1e3,
                           "queued_vs_call_at_a_time": t_call / t_queued,
                           "waves": q.stats()["waves"],
                           "coalesced": q.stats()["coalesced"]}
    mgr.verify_fraction = 1.0
    ratio_counts = launch_counts()
    require_launches(ratio_counts, "serve_queue_rmat_18 ratio",
                     ("finalize_pack_sweep", "bvss_spmm"))

    t0 = time.perf_counter()
    mgr.open_session("serve_beta", g, tenant="beta", max_batch=SLOTS,
                     order=False)
    beta_open_s = time.perf_counter() - t0
    for tenant in ("acme", "beta"):
        mgr.set_quota(tenant, TenantQuota(max_inflight=SLOTS // 2))
    owner = [("serve", "acme") if i % 2 == 0 else ("serve_beta", "beta")
             for i in range(len(queries))]
    runs = {}
    reset_launch_counts()
    for mode in ("drain", "pump"):
        q = RequestQueue(mgr)
        t0 = time.monotonic()
        futs = [None] * len(queries)
        if mode == "drain":
            for i, (s, a) in enumerate(zip(queries, arrivals)):
                name, tenant = owner[i]
                futs[i] = q.submit(name, s, tenant=tenant,
                                   not_before=t0 + a)
            q.drain(wait=True)
        else:
            q.start(poll_s=0.001)

            def client(parity, q=q, t0=t0, futs=futs):
                for i in range(parity, len(queries), 2):
                    name, tenant = owner[i]
                    futs[i] = q.submit(name, queries[i], tenant=tenant,
                                       not_before=t0 + arrivals[i])

            threads = [threading.Thread(target=client, args=(k,))
                       for k in (0, 1)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60.0)
            if any(th.is_alive() for th in threads):
                q.stop(drain=False)
                fail("serve_queue_rmat_18: a submitting thread hung")
            try:
                for f in futs:
                    f.result(120.0)
            finally:
                q.stop()
        makespan = time.monotonic() - t0
        got = [f.result(0) for f in futs]
        check_levels(f"serve_queue_rmat_18 {mode}", g, queries, got, oracle)
        runs[mode] = {"makespan_ms": makespan * 1e3, **q.stats()}
    counts = launch_counts()
    require_launches(counts, "serve_queue_rmat_18", ("bvss_spmm",))
    counts = {k: c + ratio_counts[k] for k, c in counts.items()}
    coalesced = sum(r["coalesced"] for r in runs.values())
    if coalesced == 0 or any(r["completed"] != len(queries)
                             for r in runs.values()):
        fail(f"serve_queue_rmat_18: no coalescing or lost requests: {runs}")
    if mgr.stats()["quarantines"]:
        fail(f"serve_queue_rmat_18: an unfaulted session quarantined: "
             f"{mgr.stats()}")
    emit({"phase": "serve_queue_rmat_18", "requests": len(queries),
          "tenants": 2, "max_inflight": SLOTS // 2,
          "beta_open_session_s": beta_open_s,
          "single_query_ms": t1 * 1e3, "mean_gap_ms": t1 / 4 * 1e3,
          "unverified": ratios, "runs": runs,
          "verified": mgr.stats()["verified"],
          "launches": counts, "card": card})
    return counts


def launch_counter_phase(torch, sess, g, oracle, queries, card: str) -> None:
    """The cost of the launch counter's lock, the one change this tier
    makes on the paths of the older phases.  Host nanoseconds a call of
    ``_build.count`` (the lock), of the same function without the lock,
    and of the bare ``+=`` the wrappers did before; then the serving
    session's wave of 24 in six turns, the lock on and off in alternating
    order, every wave's answers those of the first, which equal the
    oracle's."""
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    class Entry:
        launches = 0

    def unlocked(entry):
        entry.launches += 1

    def inline(n):
        for _ in range(n):
            Entry.launches += 1

    def called(fn, n):
        for _ in range(n):
            fn(Entry)

    n = 200_000
    per_call = {"locked": [], "unlocked": [], "inline": []}
    for _ in range(5):
        for key, run in (("locked", lambda: called(_build.count, n)),
                         ("unlocked", lambda: called(unlocked, n)),
                         ("inline", lambda: inline(n))):
            t0 = time.perf_counter()
            run()
            per_call[key].append((time.perf_counter() - t0) / n * 1e9)
    locked = _build.count
    waves = {"locked": [], "unlocked": []}
    reset_launch_counts()
    first = sess.levels_batch(queries)
    per_wave = sum(launch_counts().values())
    check_levels("launch_counter", g, queries, first, oracle)
    try:
        for turn in range(6):
            for key in (("locked", "unlocked") if turn % 2 == 0
                        else ("unlocked", "locked")):
                _build.count = locked if key == "locked" else unlocked
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = sess.levels_batch(queries)
                waves[key].append((time.perf_counter() - t0) * 1e3)
                if any(not np.array_equal(a, b) for a, b in zip(out, first)):
                    fail("launch_counter: a wave's answer changed")
    finally:
        _build.count = locked
    ns = {k: statistics.median(v) for k, v in per_call.items()}
    emit({"phase": "launch_counter", "calls": n, "ns_per_call": ns,
          "ns_per_call_samples": per_call, "launches_per_wave": per_wave,
          "lock_us_per_wave": (ns["locked"] - ns["unlocked"]) * per_wave
          / 1e3,
          "wave_ms": waves, "wave_median_ms": {
              k: statistics.median(v) for k, v in waves.items()},
          "card": card})


def serve_deadline_phase(torch, rt, card: str):
    """Deadlines on ``grid2d(512, 512)`` (1,023 levels from a corner): a
    whole ``levels_batch`` call with a 0.2 s deadline comes back as
    TimeoutResults, each the oracle's levels up to its depth; then a queue
    where one request has that deadline and seven do not, the seven equal
    to the oracle in full."""
    import warnings
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import RequestQueue
    side = DEADLINE_SIDE
    g = rt.generators.grid2d(side, side)
    oracle = memo_oracle(rt)
    depth_max = 2 * side - 1
    mgr = rt.GraphSessionManager()
    sess = mgr.open_session("grid", g, max_batch=SLOTS)
    # corners and edge midpoints: every BFS runs 767 to 1,022 levels
    sources = [0, side - 1, g.n - side, g.n - 1, side // 2,
               g.n - side // 2 - 1, (side // 2) * side,
               (side // 2) * side + side - 1]
    sess.levels_batch(sources[:2])                     # warm: allocator
    reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")              # the harvest warns
        t0 = time.perf_counter()
        out = mgr.levels_batch("grid", sources, deadline_s=DEADLINE_S)
        call_s = time.perf_counter() - t0
        depths = [check_partial("serve_deadline_grid_512", g, r, oracle,
                                depth_max) for r in out]
        q = RequestQueue(mgr)
        futs = [q.submit("grid", s, deadline_s=DEADLINE_S if i == 0
                         else None) for i, s in enumerate(sources)]
        t0 = time.perf_counter()
        q.drain()
        queue_s = time.perf_counter() - t0
    got = [f.result(0) for f in futs]
    queue_depth = check_partial("serve_deadline_grid_512 queue", g, got[0],
                                oracle, depth_max)
    check_levels("serve_deadline_grid_512 queue", g, sources[1:], got[1:],
                 oracle)
    counts = launch_counts()
    require_launches(counts, "serve_deadline_grid_512", ("bvss_spmm",))
    emit({"phase": "serve_deadline_grid_512", "n": g.n, "m": g.m,
          "deadline_s": DEADLINE_S, "call_ms": call_s * 1e3,
          "harvest_depths": depths, "queue_ms": queue_s * 1e3,
          "queue_harvest_depth": queue_depth,
          "full_levels": [int(oracle(g, s)[oracle(g, s) != INF].max())
                          for s in sources],
          "queue_stats": q.stats(), "stats": mgr.stats(),
          "launches": counts, "card": card})
    return counts


def serve_faults_phase(torch, rt, card: str):
    """The fault gauntlet on the hand kernels, ``rmat(16)``: for each of
    ``corrupt_spmm_tile``, ``corrupt_push_tile`` (forced push) and
    ``nan_sigma``, a session of its own through a manager; unverified, the
    faulted answer differs from the oracle (the seam reaches the kernel
    on the card); under ``verify_fraction=1.0`` the session quarantines,
    every answer equals the oracle and a DegradedServiceWarning is
    raised.  A clean ``FaultPlan()`` session must not quarantine.  The
    sessions skip the ordering pass (PERF.md section 4)."""
    import warnings
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import betweenness_ref
    from repro_torch.serve import DegradedServiceWarning, FaultPlan
    g = rt.generators.rmat(FAULT_SCALE)
    oracle = memo_oracle(rt)
    rng = np.random.default_rng(SEED + 16)
    srcs = [int(s) for s in rng.choice(np.flatnonzero(g.out_degree > 0),
                                       FAULT_QUERIES, replace=False)]
    plans = {
        "corrupt_spmm_tile": (FaultPlan(corrupt_spmm_tile=True), {},
                              ("bvss_spmm",)),
        "corrupt_push_tile": (FaultPlan(corrupt_push_tile=True),
                              {"direction": "push"}, ("bvss_push",)),
        "nan_sigma": (FaultPlan(nan_sigma=True), {}, ("bvss_spmm_w",)),
        "clean": (FaultPlan(), {}, ("bvss_spmm",)),
    }
    rows, total = {}, {}
    for name, (plan, opts, kernels) in plans.items():
        mgr = rt.GraphSessionManager(verify_fraction=0.0)
        sess = mgr.open_session(name, g, max_batch=SLOTS, fault_plan=plan,
                                order=False, **opts)
        reset_launch_counts()
        # unverified: the fault reaches the answer (levels that differ
        # from the oracle; non-finite betweenness scores)
        if name == "nan_sigma":
            diverged = int(np.sum(~np.isfinite(sess.betweenness_batch(srcs))))
        else:
            bad = [sess.levels(s) for s in srcs] \
                if name == "corrupt_push_tile" else sess.levels_batch(srcs)
            diverged = sum(not np.array_equal(lv, oracle(g, s))
                           for s, lv in zip(srcs, bad))
        unverified = launch_counts()
        # verified: quarantined, correct, announced
        mgr.verify_fraction = 1.0
        reset_launch_counts()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if name == "nan_sigma":
                bc = mgr.betweenness(name, srcs)
                want = betweenness_ref(g, srcs)
                err = np.abs(bc - want)
                if not np.all(np.isfinite(bc)) or \
                        bool((err > 1e-4 + 1e-4 * np.abs(want)).any()):
                    fail(f"serve_faults nan_sigma: the degraded betweenness "
                         f"differs from betweenness_ref")
            if name == "corrupt_push_tile":
                out = [mgr.levels(name, s) for s in srcs]
            else:
                out = mgr.levels_batch(name, srcs)
        verified = launch_counts()
        check_levels(f"serve_faults_rmat_{FAULT_SCALE} {name}", g, srcs,
                     out, oracle)
        warned = sum(issubclass(x.category, DegradedServiceWarning)
                     for x in w)
        st = mgr.stats()
        if name == "clean":
            if diverged or st["quarantines"] or warned:
                fail(f"serve_faults: the clean session diverged or "
                     f"quarantined: {diverged} {st}")
        elif not diverged:
            fail(f"serve_faults {name}: the unverified fault did not change "
                 f"the answer: the seam missed the kernel")
        elif st["quarantines"] != 1 or not warned:
            fail(f"serve_faults {name}: not quarantined ({st}, {warned} "
                 f"warnings)")
        require_launches(unverified, f"serve_faults {name}", kernels)
        if name == "corrupt_push_tile" and (
                unverified["bvss_push_level"] or unverified["bvss_pull"]):
            fail(f"serve_faults corrupt_push_tile: a forced push level went "
                 f"around the seam: {unverified}")
        counts = {k: unverified[k] + verified[k] for k in unverified}
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        rows[name] = {"diverged": diverged, "stats": st,
                      "degraded_warnings": warned,
                      "quarantine_reason": mgr._sessions[name]
                      .quarantine_reason,
                      "unverified_launches": unverified,
                      "verified_launches": verified}
        del sess, mgr
    emit({"phase": f"serve_faults_rmat_{FAULT_SCALE}", "n": g.n, "m": g.m,
          "sources": srcs, "plans": rows, "launches": total, "card": card})
    return total


def launch_service_phase(torch, card: str) -> dict:
    """``python -m repro_torch.launch.bfs --service --queue
    --verify-fraction 1.0`` in process, on the card: it must end
    ``VERIFIED vs oracle``."""
    import contextlib
    import io
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import bfs as launcher
    reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_call(launcher.main, SERVICE_ARGS)
    counts = launch_counts()
    lines = buf.getvalue().strip().splitlines()
    if not lines[-1].endswith("VERIFIED vs oracle") or \
            not lines[-2].startswith("[bfs] queue: "):
        fail(f"launch_service: {lines}")
    require_launches(counts, "launch_service", ("bvss_spmm",))
    emit({"phase": "launch_service", "args": SERVICE_ARGS, "lines": lines,
          "launches": counts, "card": card})
    return counts


def serve_bench_phase(torch, name: str, module, kernels: tuple,
                      card: str) -> dict:
    """A serving bench at its default size; its summary on one line, every
    answer verified."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = bench_call(module.run, scale=SERVE_BENCH_SCALE, verbose=False)
    counts = launch_counts()
    if out["summary"]["all_verified"] is not True:
        fail(f"{name}: not all verified: {out['summary']}")
    require_launches(counts, name, kernels)
    emit({"phase": name, "scale": SERVE_BENCH_SCALE,
          "summary": out["summary"], "graphs": out["graphs"],
          "launches": counts, "card": card})
    return counts


# ---------------------------------------------------------------------------
# phase 10: autotuning and streaming edge updates
# ---------------------------------------------------------------------------
HYBRID_SCALE = 18                # bench_hybrid's suite: n = 262,144
HYBRID_REPS = 2                  # timed sweeps an engine and graph
PATCH_EDGES = 256                # inserts, and deletes, of the patched update
REWEIGHTS = 64                   # existing edges of the reweight


def ms_per_bfs(rows: list) -> float:
    return statistics.mean(r["bfs_ms"] for r in rows)


def autotune_phase(torch, rt, name: str, p, g, sources, oracle, card: str
                   ) -> tuple[dict, dict]:
    """``prepare(p.graph, order=False, engine=p.engine_name,
    autotune=True)`` on an ordered preparation of an earlier phase: the
    TileConfig, the seconds ``tune`` took and its ``bvss_pull`` and
    ``bvss_push`` launches; the levels of the same sources (internal ids
    of the same ordering) equal to the oracle, ms per BFS and push levels
    beside the default knobs' (``p``'s engine, run again on the same
    sources right before the tuned one); then a second prepare of the class,
    which must time nothing: no tuning run, one cache hit, no launch.
    Returns the launches of the tuned BFSs and of ``tune``."""
    from repro_torch.core import autotune, policy
    from repro_torch.core.bfs import queue_widths
    from repro_torch.kernels import launch_counts, reset_launch_counts
    autotune.clear_cache()          # this phase times its own tuning
    real_tune, spent = policy.tune, []

    def timed_tune(*args, **kwargs):
        t0 = time.perf_counter()
        cfg = real_tune(*args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return cfg

    before = dict(autotune.stats)
    reset_launch_counts()
    policy.tune = timed_tune        # prepare's tune, timed alone
    try:
        t0 = time.perf_counter()
        pt = rt.prepare(p.graph, order=False, engine=p.engine_name,
                        autotune=True)
        prepare_s = time.perf_counter() - t0
    finally:
        policy.tune = real_tune
    tune_counts = launch_counts()
    cfg = pt.tile_config
    if cfg is None or cfg.source != "tuned" or len(spent) != 1 or \
            autotune.stats["tune_runs"] != before["tune_runs"] + 1:
        fail(f"{name}: prepare(autotune=True) did not tune once: {cfg}, "
             f"{autotune.stats}")
    require_launches(tune_counts, f"{name}: tune", ("bvss_pull",
                                                    "bvss_push"))

    def caller_levels(s):
        return pt.levels(int(p.perm[s]))[p.perm]

    reset_launch_counts()
    default_rows = run_sources(torch, g, p.levels, sources, oracle)
    default_counts = launch_counts()
    reset_launch_counts()
    rows = run_sources(torch, g, caller_levels, sources, oracle)
    counts = launch_counts()
    require_launches(counts, name, ("bvss_pull", "finalize_pack_sweep"))
    require_push_levels(counts, name)

    # the same class again: no tuning run, one cache hit, no launch
    before = dict(autotune.stats)
    reset_launch_counts()
    t0 = time.perf_counter()
    again = rt.prepare(p.graph, order=False, engine=p.engine_name,
                       autotune=True)
    again_s = time.perf_counter() - t0
    again_counts = launch_counts()
    if again.tile_config.source != "cached" or \
            autotune.stats["tune_runs"] != before["tune_runs"] or \
            autotune.stats["cache_hits"] != before["cache_hits"] + 1 or \
            again_counts["bvss_pull"] or again_counts["bvss_push"]:
        fail(f"{name}: the second prepare of the class re-tuned: "
             f"{again.tile_config}, {autotune.stats}, {again_counts}")
    emit({"phase": name, "n": g.n, "num_vss": p.bvss.num_vss,
          "max_vss_per_set": p.bvss.max_vss_per_set,
          "tile_config": {"pull_widths": list(cfg.pull_widths),
                          "push_cap": cfg.push_cap, "alpha": cfg.alpha,
                          "source": cfg.source},
          "default_widths": list(queue_widths(
              p.bvss.num_vss, 2)),
          "tune_s": spent[0], "prepare_s": prepare_s,
          "tune_launches": {k: tune_counts[k]
                            for k in ("bvss_pull", "bvss_push")},
          "tuned_ms_per_bfs": ms_per_bfs(rows),
          "default_ms_per_bfs": ms_per_bfs(default_rows),
          "tuned_push_levels": counts["bvss_push_level"],
          "default_push_levels": default_counts["bvss_push_level"],
          "tuned_pull_levels": counts["bvss_pull"],
          "default_pull_levels": default_counts["bvss_pull"],
          "sources": rows, "second_prepare_s": again_s,
          "second_prepare_launches": {k: again_counts[k]
                                      for k in ("bvss_pull", "bvss_push")},
          "autotune_stats": dict(autotune.stats), "launches": counts,
          "card": card})
    return counts, tune_counts


def patch_safe_batch(p, rng, n_ins: int, n_del: int):
    """Caller-id edges the patched path takes: inserts of absent edges
    beside an existing edge, in its slice (a new bit of an existing slice,
    so no slice set gains a row), and deletes of present edges whose slice
    keeps another bit (at most one a slice, so no set loses a row)."""
    from repro_torch.graphs import src_of_edges
    g, sigma = p.graph, p.bvss.sigma
    n = g.n
    src = src_of_edges(g).astype(np.int64)
    dst = g.indices.astype(np.int64)
    keys = src * n + dst                                  # ascending

    def present(k):
        pos = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
        return keys[pos] == k

    order = rng.permutation(len(keys))
    cand = order[:8 * n_ins]
    a2 = (src[cand] // sigma) * sigma + rng.integers(0, sigma, len(cand))
    b2 = dst[cand]
    ok = (a2 < n) & (a2 != b2) & ~present(a2 * n + b2)
    k_ins = a2[ok] * n + b2[ok]
    _, first = np.unique(k_ins, return_index=True)
    k_ins = k_ins[np.sort(first)][:n_ins]
    cand = order[8 * n_ins:8 * n_ins + 64 * n_del]
    base = (src[cand] // sigma) * sigma
    other = np.zeros(len(cand), dtype=bool)
    for bit in range(sigma):
        a3 = base + bit
        other |= (a3 != src[cand]) & (a3 < n) & present(a3 * n + dst[cand])
    slice_key = (src[cand] // sigma) * n + dst[cand]
    _, first = np.unique(slice_key, return_index=True)
    keep = np.zeros(len(cand), dtype=bool)
    keep[first] = True
    k_del = keys[cand[keep & other]][:n_del]
    if len(k_ins) < n_ins or len(k_del) < n_del:
        fail(f"found {len(k_ins)} inserts and {len(k_del)} deletes for a "
             f"patch, wanted {n_ins} and {n_del}")
    inv = p.inv

    def caller(k):
        return [(int(inv[a]), int(inv[b])) for a, b in zip(k // n, k % n)]

    return caller(k_ins), caller(k_del)


def caller_view(p):
    """The prepared graph in caller ids and its weights in the caller
    CSR's edge order (ascending caller keys; one sort for both)."""
    from repro_torch.graphs import Graph, src_of_edges
    g, n = p.graph, p.graph.n
    keys = p.inv[src_of_edges(g)] * n + p.inv[g.indices.astype(np.int64)]
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys // n, minlength=n), out=indptr[1:])
    gc = Graph(n, indptr, (keys % n).astype(np.int32))
    return gc, None if p.weights is None else p.weights[order]


def check_epoch(torch, rt, name: str, sess, sources, queries, fsrcs,
                card: str) -> dict:
    """After an epoch swap: ``levels`` of ``sources``, a wave of
    ``queries`` through the slots, a betweenness cohort of ``fsrcs`` and
    ``sssp`` from ``fsrcs[0]``, each against the host oracles of the
    mutated caller graph at PERF.md §2's tolerances."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import betweenness_ref, sssp_ref
    t0 = time.perf_counter()
    gc, wc = caller_view(sess.prepared)
    oracle = memo_oracle(rt)
    view_s = time.perf_counter() - t0
    reset_launch_counts()
    rows = run_sources(torch, gc, sess.levels, sources, oracle)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lvs = sess.levels_batch(queries)
    wave_s = time.perf_counter() - t0
    check_levels(name, gc, queries, lvs, oracle)
    t0 = time.perf_counter()
    bc = sess.betweenness_batch(fsrcs)
    bc_s = time.perf_counter() - t0
    want = betweenness_ref(gc, fsrcs)
    err = np.abs(bc - want)
    if not np.all(np.isfinite(bc)) or \
            bool((err > 1e-4 + 1e-4 * np.abs(want)).any()):
        fail(f"{name}: betweenness differs from betweenness_ref (max abs "
             f"err {float(err.max())})")
    t0 = time.perf_counter()
    dist = sess.sssp(fsrcs[0])
    sssp_s = time.perf_counter() - t0
    if not np.array_equal(dist, sssp_ref(gc, [fsrcs[0]], wc)[0]):
        fail(f"{name}: sssp differs from Dijkstra on the mutated graph")
    counts = launch_counts()
    require_launches(counts, name, ("bvss_pull", "finalize_pack_sweep",
                                    "bvss_spmm", "bvss_spmm_w",
                                    "bvss_spmm_t", "bvss_spmm_minplus"))
    return {"levels_ms_per_bfs": ms_per_bfs(rows),
            "wave_ms": wave_s * 1e3, "betweenness_ms": bc_s * 1e3,
            "betweenness_max_abs_err": float(err.max()),
            "sssp_ms": sssp_s * 1e3, "caller_view_s": view_s,
            "m": int(gc.m), "launches": counts}


def update_edges_phase(torch, rt, sess, g, sources, queries, fsrcs,
                       oracle, card: str) -> dict:
    """Streaming edge updates on the weighted ``rmat(18)`` session, in
    caller ids, each swap held to the oracles of the mutated graph
    (:func:`check_epoch`): (a) ``PATCH_EDGES`` inserts of absent edges
    with dyadic weights and as many deletes (the patched path; wall
    seconds against the session's ``preprocess_s``, and the memory peak
    over the update); (b) ``REWEIGHTS`` reweights of existing edges; (c)
    one insert from a slice set with no slices, whose VSS count grows (the
    rebuilt path).  Epoch isolation: the epoch-0 ``PreparedBFS`` keeps its
    device masks and its answers, and a wave whose hook updates the
    session after its first harvest gives every other request the old
    graph's answer."""
    rng = np.random.default_rng(SEED + 10)
    p0 = sess.prepared
    masks0 = p0.problem.dev.masks.clone()
    checksum0 = int(p0.problem.dev.masks.to(torch.int64).sum())
    total: dict = {}
    steps = []

    def swap(tag, path, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = sess.update_edges(**kw)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        if rep is None or rep.path != path or rep.epoch != sess.epoch:
            fail(f"update_edges_rmat_18 ({tag}): expected the {path} path, "
                 f"got {rep}")
        check = check_epoch(torch, rt, f"update_edges_rmat_18 ({tag})",
                            sess, sources, queries, fsrcs, card)
        for k, v in check.pop("launches").items():
            total[k] = total.get(k, 0) + v
        steps.append({"update": tag, "path": rep.path, "epoch": rep.epoch,
                      "sets_touched": rep.sets_touched,
                      "vss_rows_rewritten": rep.vss_rows_rewritten,
                      "n_inserted": rep.n_inserted,
                      "n_deleted": rep.n_deleted,
                      "n_reweighted": rep.n_reweighted,
                      "stale_edges": rep.stale_edges, "reason": rep.reason,
                      "update_s": update_s,
                      "update_over_preprocess": update_s / sess.preprocess_s,
                      "max_memory_allocated_update": peak, **check})

    def dyadic(k):
        return (rng.integers(1, 128, k) / 32.0).astype(np.float32).tolist()

    ins, dels = patch_safe_batch(sess.prepared, rng, PATCH_EDGES,
                                 PATCH_EDGES)
    swap("patch", "patched", inserts=ins, deletes=dels,
         insert_weights=dyadic(len(ins)))
    gc, _ = caller_view(sess.prepared)
    pick = rng.choice(gc.m, REWEIGHTS, replace=False)
    from repro_torch.graphs import src_of_edges
    rew = [(int(a), int(b)) for a, b in zip(src_of_edges(gc)[pick],
                                            gc.indices[pick])]
    swap("reweight", "patched", inserts=rew, insert_weights=dyadic(len(rew)))
    b = sess.prepared.bvss
    empty = np.flatnonzero(np.diff(b.real_ptrs) == 0)
    empty = empty[empty * b.sigma < b.n]
    if not len(empty):
        fail("update_edges_rmat_18: no slice set without slices to grow")
    s_int = int(empty[0]) * b.sigma
    grow = (int(sess.inv[s_int]), int(sess.inv[(s_int + b.sigma) % b.n]))
    swap("grow", "rebuilt", inserts=[grow], insert_weights=dyadic(1))

    # epoch isolation: the epoch-0 state is untouched and answers as before
    if not torch.equal(p0.problem.dev.masks, masks0) or \
            int(p0.problem.dev.masks.to(torch.int64).sum()) != checksum0:
        fail("update_edges_rmat_18: the epoch-0 device masks changed")
    check_levels("update_edges_rmat_18 (epoch 0)", g, sources[:2],
                 [p0.levels(s) for s in sources[:2]], oracle)
    # a wave that updates the session from its hook keeps its own epoch:
    # the first query with an out-edge runs a level, then is harvested
    g_before, _ = caller_view(sess.prepared)
    before = memo_oracle(rt)
    target = next(i for i, q in enumerate(queries)
                  if g_before.out_degree[q] > 0)
    mid_ins, _ = patch_safe_batch(sess.prepared, rng, 8, 0)
    hooked = []

    def on_harvested(i, lv):
        hooked.append(sess.update_edges(inserts=mid_ins,
                                        insert_weights=dyadic(8)))

    t0 = time.perf_counter()
    got = sess.levels_batch(
        queries, should_harvest=lambda i: i == target and not hooked,
        on_harvested=on_harvested)
    mid_s = time.perf_counter() - t0
    if len(hooked) != 1 or hooked[0].path != "patched" or \
            got[target] is not None:
        fail(f"update_edges_rmat_18: the mid-wave update did not run once "
             f"on the patched path: {hooked}")
    rest = [i for i in range(len(queries)) if i != target]
    check_levels("update_edges_rmat_18 (mid-wave)", g_before,
                 [queries[i] for i in rest], [got[i] for i in rest], before)
    g_after, _ = caller_view(sess.prepared)
    check_levels("update_edges_rmat_18 (after the mid-wave update)",
                 g_after, sources[:1], [sess.levels(sources[0])],
                 memo_oracle(rt))
    emit({"phase": "update_edges_rmat_18", "n": g.n, "m0": g.m,
          "preprocess_s": sess.preprocess_s, "steps": steps,
          "epoch0_mask_checksum": checksum0, "epoch0_unchanged": True,
          "mid_wave": {"epoch": sess.epoch, "wave_ms": mid_s * 1e3,
                       "old_epoch_answers": len(queries) - 1},
          "sources": len(sources), "wave_queries": len(queries),
          "cohort": len(fsrcs),
          "tolerance": "levels and SSSP (dyadic weights) exact; "
                       "betweenness rtol 1e-4, atol 1e-4",
          "launches": total, "card": card})
    return total


def update_reprepare_phase(torch, rt, sess, g, card: str) -> dict:
    """``staleness_budget=1`` on the ``rmat(16)`` session: two inserts
    spend it, so the update re-runs the whole pipeline (Jaccard ordering
    included) on the mutated graph; levels equal to the oracle."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(SEED + 16)
    ins, _ = patch_safe_batch(sess.prepared, rng, 2, 0)
    t0 = time.perf_counter()
    rep = sess.update_edges(inserts=ins, staleness_budget=1)
    update_s = time.perf_counter() - t0
    if rep is None or rep.path != "reprepared" or sess.epoch != 1:
        fail(f"update_reprepare_rmat_16: expected the reprepared path, got "
             f"{rep}")
    gc, _ = caller_view(sess.prepared)
    sources = [int(ins[0][0])] + [int(s) for s in rng.choice(g.n, 3,
                                                            replace=False)]
    reset_launch_counts()
    rows = run_sources(torch, gc, sess.levels, sources, memo_oracle(rt))
    counts = launch_counts()
    require_launches(counts, "update_reprepare_rmat_16",
                     ("bvss_pull", "finalize_pack_sweep"))
    emit({"phase": "update_reprepare_rmat_16", "n": g.n, "m": int(gc.m),
          "path": rep.path, "reason": rep.reason,
          "stale_edges": rep.stale_edges, "update_s": update_s,
          "ordering": sess.ordering, "sources": rows, "launches": counts,
          "card": card})
    return counts


def update_serving_phase(torch, rt, mgr, card: str) -> dict:
    """Phase 9's manager, verification on: ``mgr.update_edges`` on the
    ``rmat(18)`` session (16 inserts, 16 deletes), then a queued drain of
    SLOTS requests: no quarantine, every future the oracle's on the new
    graph, the event book's ``update-edges`` entry."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import RequestQueue
    rng = np.random.default_rng(SEED + 9)
    rec = mgr._sessions["serve"]
    sess = rec.session
    mgr.verify_fraction = 1.0
    before = mgr.stats()
    ins, dels = patch_safe_batch(sess.prepared, rng, 16, 16)
    t0 = time.perf_counter()
    rep = mgr.update_edges("serve", inserts=ins, deletes=dels,
                           tenant="acme")
    update_s = time.perf_counter() - t0
    event = mgr.events[-1]
    want_event = {"kind": "update-edges", "name": "serve",
                  "tenant": "acme", "path": rep.path, "epoch": rep.epoch,
                  "n_inserted": len(ins), "n_deleted": len(dels)}
    if rep.path != "patched" or event != want_event:
        fail(f"update_serving_rmat_18: {rep}, event {event}")
    gc, _ = caller_view(sess.prepared)
    queries = [int(ins[0][0])] + [int(s) for s in rng.choice(
        gc.n, SLOTS - 1, replace=False)]
    q = RequestQueue(mgr)
    reset_launch_counts()
    t0 = time.perf_counter()
    futs = [q.submit("serve", s, tenant="acme") for s in queries]
    q.drain()
    drain_s = time.perf_counter() - t0
    counts = launch_counts()
    require_launches(counts, "update_serving_rmat_18", ("bvss_spmm",))
    check_levels("update_serving_rmat_18", gc, queries,
                 [f.result(0) for f in futs], memo_oracle(rt))
    st = mgr.stats()
    if st["quarantines"] != before["quarantines"] or \
            st["verified"] - before["verified"] != len(queries):
        fail(f"update_serving_rmat_18: {st} after {before}")
    emit({"phase": "update_serving_rmat_18", "path": rep.path,
          "epoch": rep.epoch, "update_s": update_s,
          "queries": len(queries), "drain_ms": drain_s * 1e3,
          "queue": q.stats(), "event": event,
          "verified": st["verified"] - before["verified"],
          "quarantines": st["quarantines"], "launches": counts,
          "card": card})
    return counts


def bench_hybrid_phase(torch, card: str) -> dict:
    """``repro_torch.bench.bench_hybrid`` at scale HYBRID_SCALE on the
    card: per graph the pull and tuned hybrid ms per BFS, the geomean and
    ``all_verified`` (every graph oracle-exact in all three directions)."""
    from repro_torch.bench import bench_hybrid
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = bench_hybrid.run(scale=HYBRID_SCALE, reps=HYBRID_REPS,
                           verbose=False)
    counts = launch_counts()
    require_launches(counts, "bench_hybrid",
                     ("bvss_pull", "bvss_push_level",
                      "finalize_pack_sweep"))
    if not out["summary"]["all_verified"]:
        fail(f"bench_hybrid: not all verified: {out['graphs']}")
    emit({"phase": "bench_hybrid", "scale": HYBRID_SCALE,
          "graphs": {k: {"n": v["n"], "levels": v["levels"],
                         "num_vss": v["num_vss"],
                         "base_widths": v["base_widths"],
                         "tuned": v["tuned"],
                         "pull_ms": v["pull_sec"] * 1e3,
                         "hybrid_ms": v["hybrid_sec"] * 1e3,
                         "speedup": v["speedup_hybrid_vs_pull"],
                         "timed": v["timed"]}
                     for k, v in out["graphs"].items()},
          "summary": out["summary"], "launches": counts, "card": card})
    return counts


# ---------------------------------------------------------------------------
# phase 11: the mesh-native BFS on torch.distributed, at world size 1
# ---------------------------------------------------------------------------
MESH_LAZY_GRID_SOURCES = 2       # the grid's lazy sources, as phase 3's lazy
MESH_PROFILE_LEVELS = 256        # the grid's profiled and sync-counted levels
MESH_LAUNCH_ARGS = ["--graph", "road", "--scale", str(CLI_SCALE),
                    "--engine", "blest_full", "--sources", "2"]


def mesh_init(torch):
    """One NCCL rank on this card: the process group (a TCP store on
    127.0.0.1) and the 1-D ``(1,)`` and 2-D ``(1, 1)`` meshes over it.
    One card holds one NCCL rank, so the mesh runs at world size 1 here;
    two ranks on one card are refused by NCCL, and gloo has no CUDA
    all-gather."""
    import socket

    import torch.distributed as dist

    from repro_torch.distributed import bfs_mesh, bfs_mesh2d
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    return bfs_mesh(1), bfs_mesh2d(1, 1)


def host_profile(torch, run, top: int = 12) -> list:
    """Where one ``run()``'s host time goes: cProfile after a warm run,
    the ``top`` functions by their own time (tottime, ms) and calls."""
    import cProfile
    import pstats
    run()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"fn": f"{Path(f).name}:{line}({fn})", "calls": v[1],
             "tottime_ms": v[2] * 1e3, "cumtime_ms": v[3] * 1e3}
            for (f, line, fn), v in rows]


def mesh_runs(torch, g, p, levels_fn, sources, oracle, cap=None,
              count_fn=None, count_cap=None) -> tuple[list, dict]:
    """Run ``levels_fn(internal src)`` for each source (mapped through the
    phase's ordering ``p.perm``), equal to the oracle (cut at ``cap``
    levels when given); per source the ms per BFS, the levels run and the
    comm ledger's bytes, each also per level.  Then the first source once
    more through ``count_fn`` (default ``levels_fn``; cut at
    ``count_cap``) under CUDA's sync debug mode, which warns at every
    device-to-host synchronisation: its count, a level (not timed: the
    warnings cost host time)."""
    import warnings

    from repro_torch.distributed import comm_ledger
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def run(s, fn=levels_fn, cap=cap):
        want = oracle(g, s)
        if cap is not None:
            want = np.where(want <= cap, want, INF)
        lv = fn(int(p.perm[s]))[p.perm]
        if not np.array_equal(lv, want):
            fail(f"mesh levels from source {s} differ from the oracle at "
                 f"{int(np.count_nonzero(lv != want))} vertices")
        levels_run = int(want[want != INF].max()) + 1
        return levels_run if cap is None else min(levels_run, cap)

    rows = []
    reset_launch_counts()
    for s in sources:
        torch.cuda.synchronize()
        with comm_ledger() as events:
            t0 = time.perf_counter()
            levels_run = run(s)
            dt = time.perf_counter() - t0
        comm = sum(nb for _, nb in events)
        rows.append({"src": int(s), "bfs_ms": dt * 1e3,
                     "levels_run": levels_run, "comm_bytes": comm,
                     "comm_bytes_per_level": comm / levels_run,
                     "comm_events": len(events)})
    counts = launch_counts()
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            levels_run = run(sources[0], count_fn or levels_fn,
                             count_cap if count_fn else cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n_syncs = sum("synchroniz" in str(w.message) for w in syncs)
    rows[0].update(host_syncs=n_syncs, host_syncs_levels=levels_run,
                   host_syncs_per_level=n_syncs / levels_run)
    return rows, counts


def mesh_phase(torch, rt, name: str, g, p, sources, oracle, single: dict,
               meshes, card: str, *, lazy_sources: int, cap: int | None
               ) -> dict:
    """The mesh-native path on the phase's ordered graph ``p.graph``
    (``prepare(order=False, mesh=)``, no second ordering pass): the 1-D
    ``(1,)`` mesh's eager and lazy engines for the sources, then the 2-D
    ``(1, 1)`` engine and the sharded BRS for the first source (cut at
    ``cap`` levels when given).  Each run equals the oracle, launches its
    hand kernels on the shard, and is reported beside the single-device
    ms per BFS of the same sources (``single``: phase -> rows)."""
    from repro_torch.core.bfs import make_blest_bfs, make_brs_bfs
    mesh1, mesh2 = meshes
    counts: dict = {}

    def med(rows: list) -> float:
        return statistics.median(r["bfs_ms"] for r in rows)

    t0 = time.perf_counter()
    pm = rt.prepare(p.graph, order=False, mesh=mesh1)
    prep1_s = time.perf_counter() - t0
    if pm.engine_name != p.engine_name:
        fail(f"{name}: the mesh chose {pm.engine_name}, one device "
             f"{p.engine_name}")
    pb = pm.problem
    if cap is not None:
        # where a sharded level's time goes: device (torch.profiler) and
        # host (cProfile), sharded and single-device in the same window
        for tag, prob in (("single", p.problem), ("mesh", pb)):
            bfs = make_blest_bfs(prob, lazy=False,
                                 max_levels=MESH_PROFILE_LEVELS)
            src = int(p.perm[sources[0]])
            profile(torch, lambda: bfs(src), f"{name}_{tag}", card,
                    levels_cap=MESH_PROFILE_LEVELS,
                    host_top=host_profile(torch, lambda: bfs(src)))
        del bfs
    runs = {}
    for tag, lazy, srcs in (("eager", False, sources),
                            ("lazy", True, sources[:lazy_sources])):
        fn = make_blest_bfs(pb, lazy=lazy)
        count = None if cap is None else make_blest_bfs(
            pb, lazy=lazy, max_levels=MESH_PROFILE_LEVELS)
        rows, c = mesh_runs(torch, g, p, lambda s: fn(s).cpu().numpy(),
                            srcs, oracle, count_fn=None if count is None
                            else (lambda s: count(s).cpu().numpy()),
                            count_cap=MESH_PROFILE_LEVELS)
        require_launches(c, f"{name} {tag}", ("bvss_pull",
                                               "finalize_pack_sweep"))
        require_push_levels(c, f"{name} {tag}")
        counts[tag] = c
        runs[tag] = {"sources": rows, "launches": c,
                     "median_ms": med(rows),
                     "single_device_median_ms": med(single[tag])
                     if single.get(tag) else None}
        runs[tag]["sharded_over_single"] = (
            runs[tag]["median_ms"] / runs[tag]["single_device_median_ms"]
            if single.get(tag) else None)
    brs = make_brs_bfs(pb, max_levels=cap)
    rows, c = mesh_runs(torch, g, p, lambda s: brs(s).cpu().numpy(),
                        sources[:1], oracle, cap)
    require_launches(c, f"{name} brs", ("bvss_pull", "finalize_pack_sweep"))
    counts["brs"] = c
    runs["brs"] = {"sources": rows, "launches": c}
    del brs, fn, count, pm, pb
    torch.cuda.empty_cache()
    # the 2-D partition's problem alone (the policy's global BVSS is the
    # 1-D preparation's)
    t0 = time.perf_counter()
    pb2 = rt.build_problem(p.graph, mesh=mesh2)
    prep2_s = time.perf_counter() - t0
    fn2 = make_blest_bfs(pb2, lazy=False, max_levels=cap)
    rows, c = mesh_runs(torch, g, p, lambda s: fn2(s).cpu().numpy(),
                        sources[:1], oracle, cap)
    require_launches(c, f"{name} 2-D", ("bvss_pull",))
    if c["finalize_pack_sweep"] or c["bvss_push_level"] or c["bvss_push"]:
        fail(f"{name} 2-D launched more than bvss_pull: {c}")
    counts["2d"] = c
    runs["2d"] = {"sources": rows, "launches": c}
    del fn2, pb2
    torch.cuda.empty_cache()
    total = {k: sum(cc[k] for cc in counts.values()) for k in counts["eager"]}
    emit({"phase": name, "n": g.n, "m": g.m, "world_size": 1,
          "meshes": ["(1,) data", "(1, 1) data x col"],
          "prepare_1d_s": prep1_s, "build_problem_2d_s": prep2_s,
          "levels_cap_2d_brs": cap, **runs, "launches": total,
          "card": card})
    return total


def mesh_launch_phase(torch, card: str) -> None:
    """``python -m repro_torch.launch.bfs --devices 1`` in a child process
    (it spawns its own rank and NCCL group), ending ``VERIFIED vs
    oracle``; and ``--devices 2`` raising ConfigError on a one-card
    machine before any process starts."""
    from repro_torch.errors import ConfigError
    from repro_torch.launch import bfs as launcher
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bfs", *MESH_LAUNCH_ARGS,
         "--devices", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={**__import__("os").environ,
                          "PYTHONPATH": str(ROOT / "src")})
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines or \
            not lines[-1].endswith("VERIFIED vs oracle") or \
            not any(ln.startswith("[bfs] sharded: 1 shards") for ln in lines):
        fail(f"launcher --devices 1 (rc {out.returncode}): {out.stdout}\n"
             f"{out.stderr[-3000:]}")
    refused = None
    if torch.cuda.device_count() == 1:
        try:
            launcher.main([*MESH_LAUNCH_ARGS, "--devices", "2"])
        except ConfigError as e:
            refused = str(e)
        if refused is None:
            fail("launcher --devices 2 did not raise ConfigError on one card")
    emit({"phase": "mesh_launch_cli", "lines": lines,
          "devices_2_on_one_card": refused, "card": card})


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
    from repro_torch.kernels import (_build, launch_counts, push_vss_kernel,
                                     reset_launch_counts)

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
    timed.update(phase_float_kernels(torch))
    emit({"phase": "push_level_vs_twin",
          "cases_equal": phase_push_level(torch, rt),
          "tolerance": "exact (max abs err 0)"})
    by_phase: dict = {}

    # phase 3: main path, road regime (counts read from this run)
    rng = np.random.default_rng(SEED)
    g = rt.generators.grid2d(2048, 2048)
    sources = [0] + [int(s) for s in rng.choice(g.n, 3, replace=False)]
    oracle = memo_oracle(rt)
    sess, main_counts, main_rows = session_phase(
        torch, rt, "main_path_grid2d_2048", g, sources, card, oracle,
        ("bvss_pull", "bvss_push_level", "finalize_pack_sweep"))
    by_phase["grid2d_2048"] = main_counts
    p = sess.prepared
    bfs = make_blest_bfs(p.problem, lazy=False, max_levels=PROFILE_LEVELS)
    profile(torch, lambda: bfs(int(p.perm[0])), "grid2d_2048", card,
            levels_cap=PROFILE_LEVELS)
    # the push level at the grid's own push frontiers (the corner's BFS)
    lv = np.empty(g.n, np.int32)
    lv[p.perm] = oracle(g, sources[0])
    timed["bvss_push_level"] = push_level_timing(torch, p.problem, lv,
                                                 "grid2d_2048", card)
    # the push levels alone: from the corner, the first PUSH_PROFILE_LEVELS
    # levels all push (frontiers of 1 to 128 vertices); one launch a level,
    # then the same levels through the unfused seam around bvss_push
    for tag, kw, kernel in (("push", {}, "bvss_push_level"),
                            ("push_seam", {"push_impl": push_vss_kernel},
                             "bvss_push")):
        bfs = make_blest_bfs(p.problem, lazy=False,
                             max_levels=PUSH_PROFILE_LEVELS, **kw)
        reset_launch_counts()
        profile(torch, lambda: bfs(int(p.perm[0])), f"grid2d_2048_{tag}",
                card, levels_cap=PUSH_PROFILE_LEVELS)
        counts = launch_counts()
        if (counts[kernel] != 2 * PUSH_PROFILE_LEVELS or counts["bvss_pull"]
                or counts["bvss_push"] + counts["bvss_push_level"]
                != counts[kernel]):
            fail(f"the {tag} profile did not push every level once through "
                 f"{kernel}: {counts}")

    # the lazy engine on the same prepared graph
    lazy = make_engine(p.graph, "blest_lazy", problem=p.problem)
    reset_launch_counts()
    rows = run_sources(
        torch, g, lambda s: lazy(int(p.perm[s])).cpu().numpy()[p.perm],
        sources[:2], oracle)
    lazy_rows = rows
    by_phase["lazy_grid2d_2048"] = launch_counts()
    require_launches(by_phase["lazy_grid2d_2048"], "the lazy engine",
                     ("finalize_pack_sweep", "bvss_push_level"))
    require_push_levels(by_phase["lazy_grid2d_2048"], "the lazy engine")
    emit({"phase": "lazy_grid2d_2048", "sources": rows,
          "launches": by_phase["lazy_grid2d_2048"], "card": card})
    del lazy

    # the push seam (push_impl=): the unfused push level around bvss_push,
    # from the corner, on the same prepared graph
    seam = make_engine(p.graph, "blest", problem=p.problem,
                       push_impl=push_vss_kernel)
    reset_launch_counts()
    rows = run_sources(
        torch, g, lambda s: seam(int(p.perm[s])).cpu().numpy()[p.perm],
        sources[:1], oracle)
    by_phase["push_seam_grid2d_2048"] = counts = launch_counts()
    require_launches(counts, "the push seam", ("bvss_push",))
    if counts["bvss_push_level"]:
        fail(f"the push seam launched bvss_push_level: {counts}")
    emit({"phase": "push_seam_grid2d_2048", "sources": rows,
          "launches": counts, "card": card})
    del seam

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
    # phase 10 on this graph: autotuning against the default knobs
    by_phase["autotune_grid"], by_phase["autotune_grid_tune"] = \
        autotune_phase(torch, rt, "autotune_grid", p, g, sources, oracle,
                       card)
    # phase 11 on this graph: the mesh-native BFS at world size 1
    meshes = mesh_init(torch)
    by_phase["mesh_grid2d_2048"] = mesh_phase(
        torch, rt, "mesh_grid2d_2048", g, p, sources, oracle,
        {"eager": main_rows, "lazy": lazy_rows}, meshes, card,
        lazy_sources=MESH_LAZY_GRID_SOURCES, cap=PROFILE_LEVELS)
    del sess, p, bfs
    torch.cuda.empty_cache()

    # phase 4: main path, social regime
    g = rt.generators.rmat(18)
    sources = [0] + [int(s) for s in rng.choice(g.n, 3, replace=False)]
    oracle = memo_oracle(rt)
    wrng = np.random.default_rng(SEED)
    weights = (wrng.integers(1, 128, g.m) / 32.0).astype(np.float32)
    sess, by_phase["rmat_18"], main_rows = session_phase(
        torch, rt, "main_path_rmat_18", g, sources, card, oracle,
        ("bvss_pull", "finalize_pack_sweep"), weights=weights)
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

    # the float-channel verbs on the same weighted preparation
    fsrcs = [0] + [int(s) for s in wrng.choice(g.n, SLOTS - 1,
                                               replace=False)]
    by_phase["betweenness_rmat_18"] = betweenness_phase(torch, sess, g,
                                                        fsrcs, card)
    real_masks = real_mask_timing(
        torch, p.problem.dev.masks[:p.bvss.num_vss], card)
    internal = p.perm[np.asarray(fsrcs)]
    by_phase["sssp_rmat_18"] = sssp_phase(torch, rt, sess, g, fsrcs, card,
                                          "sssp_rmat_18", weights)
    delta = float(weights.mean())
    profile(torch, lambda: sess._sssp_fn(SLOTS)(internal, delta),
            "sssp_rmat_18", card, sources=SLOTS, delta=delta)
    by_phase["pagerank_rmat_18"] = pagerank_phase(torch, sess, g, card)
    # the Table-2 matrix, reusing this session's ordered preparation
    by_phase["table2_rmat_18"] = table2_phase(torch, rt, "table2_rmat_18", g,
                                              card, rng, ordered=p)
    # phase 10 on this graph: autotuning, then streaming edge updates
    by_phase["autotune_rmat_18"], by_phase["autotune_rmat_18_tune"] = \
        autotune_phase(torch, rt, "autotune_rmat_18", p, g, sources,
                       oracle, card)
    # phase 11 on this graph, then the launcher's --devices; the NCCL
    # group ends here
    by_phase["mesh_rmat_18"] = mesh_phase(
        torch, rt, "mesh_rmat_18", g, p, sources, oracle,
        {"eager": main_rows}, meshes, card, lazy_sources=len(sources),
        cap=None)
    mesh_launch_phase(torch, card)
    import torch.distributed as dist
    dist.destroy_process_group()
    del meshes
    by_phase["update_edges_rmat_18"] = update_edges_phase(
        torch, rt, sess, g, sources, queries, fsrcs, oracle, card)

    del sess, p, bfs
    torch.cuda.empty_cache()

    # phase 5: the wave verbs on the symmetrised problem, cut to rmat(16)
    g = rt.generators.rmat(16)
    t0 = time.perf_counter()
    sess = rt.GraphSession(g, max_batch=SLOTS)
    emit({"phase": "prepare_rmat_16", "n": g.n, "m": g.m,
          "prepare_s": time.perf_counter() - t0, "card": card})
    by_phase["verbs_rmat_16"] = verbs_phase(torch, rt, sess, g, rng, card)
    by_phase["sssp_rmat_16"] = sssp_phase(
        torch, rt, sess, g, [int(x) for x in rng.choice(g.n, 4,
                                                        replace=False)],
        card, "sssp_unit_rmat_16", None)
    by_phase["dense_rmat_16"], timed["bit_spmm"] = dense_phase(
        torch, rt, sess, g, rng, card)
    # phase 10 on this graph: the staleness budget spent, a re-prepare
    by_phase["update_reprepare_rmat_16"] = update_reprepare_phase(
        torch, rt, sess, g, card)
    del sess
    torch.cuda.empty_cache()

    # phase 6: the Table-2 matrix on the road graph of the launcher
    from repro_torch.launch.bfs import build_graph
    by_phase["table2_road_20"] = table2_phase(
        torch, rt, "table2_road_20", build_graph("road", 20), card, rng,
        profiled=("brs", "blest_a", "csr_push"),
        push_row=timed["bvss_push_level"])
    torch.cuda.empty_cache()

    # phase 7: the kernel bench and the launcher, end to end
    by_phase["kernel_bench"] = kernel_bench_phase(torch, card)
    by_phase["launch_cli"] = cli_phase(torch, card)
    torch.cuda.empty_cache()

    # phase 8: the analytics launcher, the paper's other tables, Figure 3,
    # the RMAT scale sweep and the analytics bench
    by_phase["launch_analytics"] = analytics_cli_phase(torch, card)
    by_phase["paper_tables_host"] = paper_tables_phase(torch, card)
    by_phase["fig3_clustered_16"] = fig3_phase(torch, card)
    by_phase["bench_scale_rmat"] = scale_phase(torch, card)
    by_phase["bench_analytics"] = analytics_bench_phase(torch, card)
    torch.cuda.empty_cache()

    # phase 9: the hardened serving tier
    from repro_torch.bench import bench_queue, bench_service
    mgr, g, oracle, queries, by_phase["serve_manager_rmat_18"] = \
        serve_manager_phase(torch, rt, rng, card)
    by_phase["serve_queue_rmat_18"] = serve_queue_phase(
        torch, rt, mgr, g, oracle, queries, card)
    launch_counter_phase(torch, mgr._sessions["serve"].session, g, oracle,
                         queries, card)
    # phase 10 on this manager: an update, then queued serving
    by_phase["update_serving_rmat_18"] = update_serving_phase(torch, rt, mgr,
                                                              card)
    del mgr
    torch.cuda.empty_cache()
    by_phase["serve_deadline_grid_512"] = serve_deadline_phase(torch, rt,
                                                               card)
    by_phase[f"serve_faults_rmat_{FAULT_SCALE}"] = serve_faults_phase(
        torch, rt, card)
    by_phase["launch_service"] = launch_service_phase(torch, card)
    by_phase["bench_service_serve"] = serve_bench_phase(
        torch, "bench_service_serve", bench_service,
        ("bvss_spmm", "bit_spmm"), card)
    by_phase["bench_queue"] = serve_bench_phase(
        torch, "bench_queue", bench_queue, ("bvss_spmm",), card)

    # phase 10's last part: the hybrid bench on its own graphs
    by_phase["bench_hybrid"] = bench_hybrid_phase(torch, card)

    replaces = {
        "bvss_pull": "src/repro/kernels/bvss_pull.py:66",
        "bvss_push": "src/repro/kernels/bvss_push.py:52",
        "bvss_push_level": "src/repro/kernels/bvss_push.py:52",
        "finalize_pack_sweep": "src/repro/kernels/frontier_finalize.py:124",
        "bvss_spmm": "src/repro/kernels/mxu_pull.py:156",
        "bvss_spmm_w": "src/repro/kernels/mxu_pull.py:276",
        "bvss_spmm_t": "src/repro/kernels/mxu_pull.py:299",
        "bvss_spmm_minplus": "src/repro/kernels/mxu_pull.py:415",
        "finalize_sweep": "src/repro/kernels/frontier_finalize.py:55",
        "bit_spmm": "src/repro/kernels/mxu_pull.py:88",
    }
    sources_cu = {
        "bvss_pull": "src/repro_torch/kernels/csrc/bvss_pull.cu",
        "bvss_push": "src/repro_torch/kernels/csrc/bvss_push.cu",
        "bvss_push_level": "src/repro_torch/kernels/csrc/bvss_push.cu",
        "finalize_pack_sweep":
            "src/repro_torch/kernels/csrc/frontier_finalize.cu",
        "bvss_spmm": "src/repro_torch/kernels/csrc/bvss_spmm.cu",
        "bvss_spmm_w": "src/repro_torch/kernels/csrc/bvss_spmm_w.cu",
        "bvss_spmm_t": "src/repro_torch/kernels/csrc/bvss_spmm_t.cu",
        "bvss_spmm_minplus":
            "src/repro_torch/kernels/csrc/bvss_spmm_minplus.cu",
        "finalize_sweep":
            "src/repro_torch/kernels/csrc/frontier_finalize.cu",
        "bit_spmm": "src/repro_torch/kernels/csrc/bit_spmm.cu",
    }
    # each kernel's launches on its own main path: the single-source BFSs of
    # the road regime for bvss_pull, bvss_push_level and the fused sweep,
    # the push seam for bvss_push, the two waves for bvss_spmm,
    # the float-channel verbs for the three float tiles, the dense
    # multi-source baseline for bit_spmm, the kernel bench for
    # finalize_sweep
    main_path = {"bvss_push": ("push_seam_grid2d_2048",),
                 "bvss_spmm": ("wave_grid2d_2048", "wave_rmat_18"),
                 "bvss_spmm_w": ("betweenness_rmat_18", "pagerank_rmat_18"),
                 "bvss_spmm_t": ("betweenness_rmat_18",),
                 "bvss_spmm_minplus": ("sssp_rmat_18", "sssp_rmat_16"),
                 "bit_spmm": ("dense_rmat_16",),
                 "finalize_sweep": ("kernel_bench",)}
    library_by = {"bvss_spmm": "torch.bmm over the unpacked f32 tile",
                  "bvss_spmm_w": "torch.bmm over the unpacked f32 tile",
                  "bvss_spmm_t": "torch.bmm over the unpacked f32 tile",
                  "bit_spmm": "torch._int_mm over the unpacked int8 A"}
    timed_w1 = timed.pop("bvss_spmm_w_s1")
    timed["bvss_spmm_w"]["s1"] = timed_w1
    for name, row in (("bvss_spmm_w", timed["bvss_spmm_w"]),
                      ("bvss_spmm_w_s1", timed_w1),
                      ("bvss_spmm_t", timed["bvss_spmm_t"])):
        row["real_masks"] = real_masks[name]
    kernels = []
    for name, row in timed.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources_cu[name],
            "replaces": replaces[name],
            "launches": sum(by_phase[ph][name]
                            for ph in main_path.get(name, ("grid2d_2048",))),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row.get("library_ms"),
            "library": library_by.get(name),
            # the same numbers under the names the port's docs use
            "max_abs_diff": row["max_abs_err"], "kernel_ms": row["ms"],
            "twin_ms": row["plain_ms"],
            "launches_by_phase": {ph: c[name] for ph, c in by_phase.items()},
            **{k: v for k, v in row.items()
               if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "library_ms")},
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
