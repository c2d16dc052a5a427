"""Shared BFS level-step skeleton (DESIGN.md §2.3), PyTorch port of
``repro/core/level_pipeline.py``.

One BFS level = ``step`` (gather → pull → update: the fused
frontier-byte gather, the pull or push kernel, the scatter into levels or
marks) then ``finalize`` (finalise levels, pack the frontier words, flag
the active slice sets, compact the next queue).

The reference runs the whole loop inside one on-device
``lax.while_loop``.  Here :func:`run_levels` is a host loop: ``finalize``
ends with ONE device-to-host copy of the level's scalars (live queue
count, frontier popcount), and ``active`` reads the host copy.  That read
is the price of this port: one synchronisation per level.  Keeping the
loop on the device (a CUDA graph or a persistent kernel, paper §4.3) is
later work.

The skeleton is mesh-native (DESIGN §2.4): on every rank of a mesh the
``step`` stays local (each shard pulls and scatters its row block), the
``finalize`` exchanges the frontier words, and :func:`global_any` makes
the continuation test the same on every rank — an all-reduce whose result
rides in the level's one device-to-host copy, so a sharded level still
costs one copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

State = Any  # engine-specific state carried through the level loop


@dataclasses.dataclass(frozen=True)
class LevelPipeline:
    """One BFS level = ``step`` (gather → pull → update) then ``finalize``
    (finalise / pack / compact); ``active`` is the continuation predicate,
    evaluated on host values the last ``finalize`` copied back."""

    step: Callable[[State, int], State]
    finalize: Callable[[State, int], State]
    active: Callable[[State], bool]


def global_any(pred: torch.Tensor, groups: Sequence | None
               ) -> torch.Tensor:
    """Continuation predicate across the mesh: ``pred`` is this shard's
    local "still work to do" 0-d bool tensor; the result (a 0-d bool tensor
    on the same device, not yet copied to the host) is True iff ANY shard
    says so, and the same on every rank, so the ranks' level loops stay in
    lock-step.  ``groups=None`` is the single-device identity; each group
    of ``groups`` (one on a 1-D mesh, the column and the row group on a 2-D
    one) sums the int32 count of live shards in turn.  A sum is what NCCL
    and gloo both reduce; no bitwise reduction op is used."""
    if not groups:
        return pred
    live = pred.to(torch.int32, copy=True).reshape(1)
    for group in groups:
        dist.all_reduce(live, op=dist.ReduceOp.SUM, group=group)
    return live[0] > 0


def run_levels(pipe: LevelPipeline, state: State, *, max_levels: int
               ) -> tuple[State, int]:
    """Run the level loop; returns (final state, levels run)."""
    lvl = 0
    while pipe.active(state) and lvl < max_levels:
        lvl += 1
        state = pipe.step(state, lvl)
        state = pipe.finalize(state, lvl)
    return state, lvl


def run_levels_recorded(pipe: LevelPipeline, state: State, *,
                        max_levels: int, history: State,
                        record: Callable[[State, State, int], State]
                        ) -> tuple[State, int, State]:
    """:func:`run_levels` with a per-level *history* channel: before each
    level's ``step``, ``record(hist, state, lvl)`` folds the pre-step state
    into ``history`` (:func:`repro_torch.core.bfs.make_queue_history`).
    The Brandes backward sweep (``repro_torch.analytics.betweenness``)
    replays the recorded per-level VSS queues in reverse, so it touches
    exactly the tiles the forward phase pulled.  Returns (final state,
    levels run, history)."""
    lvl = 0
    while pipe.active(state) and lvl < max_levels:
        lvl += 1
        history = record(history, state, lvl)
        state = pipe.step(state, lvl)
        state = pipe.finalize(state, lvl)
    return state, lvl, history
