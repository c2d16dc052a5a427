"""Per-device tile autotuning for the hybrid BFS engines (DESIGN §2.8), the
port of ``repro/core/autotune.py``.

The direction-optimizing step has three static knobs: the graduated
pull-queue ladder (``widths``), the push-phase vertex cap (``push_cap``)
and the Beamer-α saturation guard.  Their best values depend on the
DEVICE (the card's launch cost against its per-row cost, or the CPU
twins') and only coarsely on the graph, so this module measures them once
per *(device type, σ, size-class)* and memoises the winner:

* ``tune(problem)`` times the pull and push entry points on SYNTHETIC
  operands of the problem's tile shapes — on a CUDA problem the
  hand-written ``bvss_pull`` and ``bvss_push`` kernels, on a CPU problem
  (or with ``use_kernels=False``) their twins — with a small rep budget
  and no graph traversal, and returns a frozen :class:`TileConfig`;
* the module-level cache keys on ``(device type, σ, pow2-bucketized
  num_vss, use_kernels)``: a second ``prepare(..., autotune=True)`` for the
  same device type and graph class times nothing (the ``stats`` counters
  make that contract testable);
* ``BLEST_AUTOTUNE=0`` in the environment disables measurement entirely
  (the default config is returned, marked ``source="disabled"``).

The timed push is ``bvss_push``, the reference's kernel, while the
engine's default push level is one ``bvss_push_level`` launch: the fitted
push model describes the former.

``core.policy.prepare(..., autotune=True)`` is the consumer: the winning
config is kept on the returned
:class:`~repro_torch.core.policy.PreparedBFS` and its widths and cap go
into the engine build.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.bfs import DEFAULT_PUSH_CAP, _round_width, queue_widths
from repro_torch.errors import ConfigError

#: the dispatch-model's far anchor: candidate widths are never timed
#: directly, only the 128-row floor and this row count are (the affine
#: model interpolates/extrapolates the rest — graph-independent budget)
MAX_TIMED_ROWS = 2048
#: timing repetitions per candidate (after one untimed warmup call)
DEFAULT_REPS = 2


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """The tuned static knobs of one hybrid engine build.

    ``source`` records provenance: ``"tuned"`` (measured this process),
    ``"cached"`` (measured earlier for the same class), ``"disabled"``
    (``BLEST_AUTOTUNE=0``: defaults, no measurement).  ``buckets`` is the
    graduation count the ladder was built with (``queue_widths``), so
    :meth:`fit` can rebuild it for another VSS count."""

    pull_widths: tuple[int, ...]
    push_cap: int
    alpha: float
    source: str
    buckets: int | None = None

    def engine_kwargs(self) -> dict:
        """The ``make_engine`` override dict this config injects."""
        return {"widths": list(self.pull_widths), "push_cap": self.push_cap,
                "alpha": self.alpha}

    def fit(self, num_vss: int) -> "TileConfig":
        """This config with its ladder rebuilt for ``num_vss`` VSSs.  The
        top rung is the queue's capacity, so a ladder built for fewer VSSs
        would drop live queue entries: a cached config serves every graph
        of its size class, and an update can grow the VSS count."""
        if self.buckets is None:
            return self
        return dataclasses.replace(
            self, pull_widths=tuple(queue_widths(num_vss, self.buckets)))


#: (device type, sigma, pow2 size class, use_kernels) -> winning TileConfig
_TUNE_CACHE: dict[tuple, TileConfig] = {}
#: observable tuning activity — the zero-retune contract's test surface
stats = {"tune_runs": 0, "cache_hits": 0}


def clear_cache() -> None:
    """Drop all memoised configs (test isolation helper)."""
    _TUNE_CACHE.clear()


def _size_class(num_vss: int) -> int:
    """Bucketize the VSS count to the next power of two: graphs in the
    same class share tile shapes closely enough to share a config."""
    b = 1
    while b < max(num_vss, 1):
        b <<= 1
    return b


def class_key(problem, use_kernels: bool) -> tuple:
    """The memoisation key of one tuning run: the problem's device type
    (``"cuda"`` or ``"cpu"``) stands where the reference has
    ``jax.default_backend()``."""
    return (problem.device.type, problem.sigma,
            _size_class(problem.num_vss), bool(use_kernels))


def default_config(problem, *, buckets: int = 2,
                   source: str = "disabled") -> TileConfig:
    """The untuned knobs every engine uses when autotuning is off."""
    return TileConfig(
        pull_widths=tuple(queue_widths(problem.num_vss, buckets)),
        push_cap=DEFAULT_PUSH_CAP, alpha=4.0, source=source,
        buckets=buckets)


def _time_call(fn: Callable, args: tuple, reps: int) -> float:
    """Best-of-``reps`` wall time of one call, in seconds.  One untimed
    warmup call absorbs the kernel build and CUDA's lazy init; on the card
    each timed call is bracketed by device synchronisations, so the time
    is the launch plus the kernel, not the launch alone."""
    device = args[0].device

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*args)
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _pull_operands(width: int, sigma: int, seed: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's draws (masks, then frontier bytes), as the int32
    carriers of the uint32 words."""
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 2 ** 32, size=(width, 32), dtype=np.uint32)
    fbytes = rng.integers(0, 2 ** sigma, size=(width,), dtype=np.uint32)
    return (torch.from_numpy(masks.view(np.int32)).to(device),
            torch.from_numpy(fbytes.view(np.int32)).to(device))


def _push_operands(width: int, sigma: int, seed: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 2 ** 32, size=(width, 32), dtype=np.uint32)
    bits = rng.integers(0, sigma, size=(width,), dtype=np.int32)
    return (torch.from_numpy(masks.view(np.int32)).to(device),
            torch.from_numpy(bits).to(device))


def _fit_dispatch_model(timed: Callable, reps: int) -> tuple[float, float]:
    """Fit the affine dispatch-cost model ``t(w) = a + b*w`` from two
    measured anchors (the PULL_TILE floor and ``MAX_TIMED_ROWS``).

    Scoring candidate widths through the fitted model instead of raw
    per-width timings keeps tuning deterministic where dispatch dominates:
    ``t(128)`` and ``t(256)`` differ by less than timer noise, so comparing
    them directly picks a random ladder — while the model's slope,
    anchored ``MAX_TIMED_ROWS`` apart, resolves far above the noise
    floor."""
    lo, hi = 128, MAX_TIMED_ROWS
    t_lo, t_hi = timed(lo, reps), timed(hi, reps)
    b = max((t_hi - t_lo) / (hi - lo), 0.0)
    a = max(t_lo - b * lo, 0.0)
    return a, b


def tune(problem, *, use_kernels: bool = True,
         buckets_candidates: Iterable[int] = (2, 3, 4),
         push_cap_candidates: Iterable[int] = (128, 256),
         reps: int = DEFAULT_REPS) -> TileConfig:
    """Fit dispatch-cost models for the pull and push entry points on the
    problem's device and pick ``problem``'s ladder and push cap through
    them; memoised per :func:`class_key`.  A cached config comes back with
    its ladder rebuilt for ``problem``'s VSS count (:meth:`TileConfig.fit`;
    the reference returns the ladder of the first graph of the class).

    Four timed calls in all (two anchors per entry point, see
    :func:`_fit_dispatch_model`); every candidate is then scored
    analytically.  The ladder score is the modeled pull time at the
    ladder's SMALLEST width plus its FULL width — the two regimes a
    traversal alternates between (trickle levels ride the small rung,
    bulk levels the full queue).  The push cap maximises the ENGAGEMENT
    RANGE: the auto heuristic only takes push when its static cost
    ``round(cap) * max_vss_per_set`` undercuts the rung the ladder would
    select, so the winning cap is the one with the most ladder rungs
    strictly above its cost (modeled push time breaks ties).
    """
    if reps < 1:
        raise ConfigError(f"autotune needs reps >= 1, got {reps!r}")
    key = class_key(problem, use_kernels)
    cached = _TUNE_CACHE.get(key)
    if cached is not None:
        stats["cache_hits"] += 1
        return dataclasses.replace(cached.fit(problem.num_vss),
                                   source="cached")
    if os.environ.get("BLEST_AUTOTUNE", "") == "0":
        return default_config(problem)
    stats["tune_runs"] += 1
    sigma = problem.sigma
    device = problem.device
    if use_kernels:
        from repro_torch.kernels import pull_vss_kernel, push_vss_kernel
        pull, push = pull_vss_kernel, push_vss_kernel
    else:
        from repro_torch.kernels.ref import bvss_pull_ref, bvss_push_ref
        pull, push = bvss_pull_ref, bvss_push_ref

    pa, pb = _fit_dispatch_model(
        lambda w, r: _time_call(lambda m, f: pull(m, f, sigma),
                                _pull_operands(w, sigma, w, device), r),
        reps)
    qa, qb = _fit_dispatch_model(
        lambda w, r: _time_call(lambda m, b: push(m, b, sigma),
                                _push_operands(w, sigma, w, device), r),
        reps)

    buckets = sorted(set(int(x) for x in buckets_candidates))
    caps = sorted(set(int(x) for x in push_cap_candidates))
    if not buckets or not caps:
        raise ConfigError("autotune needs at least one buckets and one "
                          f"push-cap candidate, got {buckets_candidates!r} "
                          f"/ {push_cap_candidates!r}")
    best_widths: tuple[int, ...] = ()
    best_buckets, best_score = buckets[0], float("inf")
    for b in buckets:
        widths = tuple(queue_widths(problem.num_vss, b))
        score = (pa + pb * widths[0]) + (pa + pb * widths[-1])
        if score < best_score:
            best_widths, best_buckets, best_score = widths, b, score

    R = max(problem.max_vss_per_set, 1)
    best_cap, best_key = DEFAULT_PUSH_CAP, None
    for cap in caps:
        pqcap = _round_width(cap)
        cost = pqcap * R
        engagement = sum(1 for w in best_widths if cost < w)
        cand = (-engagement, qa + qb * cost)
        if best_key is None or cand < best_key:
            best_cap, best_key = cap, cand

    cfg = TileConfig(pull_widths=best_widths, push_cap=best_cap,
                     alpha=4.0, source="tuned", buckets=best_buckets)
    _TUNE_CACHE[key] = cfg
    return cfg
