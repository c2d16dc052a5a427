"""Shared bench utilities: the graph suite (lab-scale stand-ins for the
paper's benchmark families) and timing/work-model helpers, a host-only copy
of ``benchmarks/common.py`` for the port.

Every engine of the port returns a torch tensor; :func:`time_engine` ends
each run in a device-to-host copy, so on the card a run's time is its
device time plus the host's share.
"""
from __future__ import annotations

import math
import subprocess
import time

import numpy as np

from repro_torch.core import BVSS, reference_bfs, resolve_device
from repro_torch.graphs import Graph
from repro_torch.graphs import generators as gen

INF = np.int32(np.iinfo(np.int32).max)


def graph_suite(scale: int = 11) -> dict[str, Graph]:
    """Lab-scale stand-ins for the paper's graph families."""
    side = int((1 << scale) ** 0.5)
    return {
        "kron": gen.rmat(scale, 16, seed=1),            # GAP-kron-like
        "urand": gen.erdos_renyi(1 << scale, 16.0, seed=2),  # GAP-urand-like
        "road": gen.grid2d(side, side, shuffle=True, seed=3),  # GAP-road-like
        "web": gen.clustered((1 << scale) // 64, 64, seed=4),  # crawl-like
        "rgg": gen.rgg2d(1 << scale, seed=5),           # rgg_24-like
        "star": gen.star(1 << scale),                   # vsp_msc-like
    }


def time_engine(fn, sources) -> float:
    """Median seconds per BFS over the source set, after one warm run;
    ``fn(src)`` returns a tensor, copied to the host inside the clock."""
    fn(int(sources[0])).cpu()   # warm: kernel build, allocator
    times = []
    for s in sources:
        t0 = time.time()
        fn(int(s)).cpu()
        times.append(time.time() - t0)
    return float(np.median(times))


def modeled_tc_pulls(g: Graph, b: BVSS, src: int, *,
                     frontier_aware: bool) -> int:
    """Exact number of VSS pull operations a queue-based (frontier-aware)
    or sweep-based (frontier-oblivious) engine performs for this BFS,
    derived from the oracle level sets (no device run needed)."""
    levels = reference_bfs(g, src)
    n_levels = int(levels[levels != INF].max()) if (levels != INF).any() \
        else 0
    if not frontier_aware:
        return b.num_vss * max(n_levels, 1)
    sigma = b.sigma
    vss_per_set = np.diff(b.real_ptrs).astype(np.int64)
    total = 0
    for lvl in range(0, n_levels):
        verts = np.flatnonzero(levels == lvl)
        sets = np.unique(verts // sigma)
        total += int(vss_per_set[sets].sum())
    return total


def median_sec(f, reps: int = 3) -> float:
    """Median seconds per call of ``f()`` over ``reps`` calls, the caller
    having warmed it; ``f`` must end in a host copy or a synchronise, as
    every verb of ``GraphSession`` does."""
    ts = []
    for _ in range(reps):
        t0 = time.time()
        f()
        ts.append(time.time() - t0)
    return float(np.median(ts))


def fmt_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def geomean(xs) -> float:
    """Geometric mean of the positive entries (0.0 if none)."""
    xs = [x for x in xs if x and x > 0]
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 0.0


def card_identity() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (first
    card), or ``"nvidia-smi unavailable"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.strip().splitlines()[0] if out.strip() else \
        "nvidia-smi unavailable"


def bench_envelope(bench: str, scale: int, device) -> dict:
    """The metadata envelope of a bench's JSON: the bench, its scale, the
    torch device it ran on and the time; on the card also the card's name
    and power limit (:func:`card_identity`)."""
    dev = resolve_device(device)
    out = {"bench": bench, "device": str(dev), "scale": scale,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if dev.type == "cuda":
        out["card"] = card_identity()
    return out
