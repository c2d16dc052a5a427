"""Fault-tolerance orchestration, the port of ``repro/ft/manager.py``
(plain Python, unchanged): restart manager, failure injection, straggler
monitor, elastic re-mesh bookkeeping.

A controller wraps the train loop with ``RestartManager.run``: an
injected ``SimulatedFailure`` (standing in for a preemption or hardware
fault) triggers a bounded-retry restart that resumes from the latest
complete checkpoint.  Checkpoints store full arrays
(``repro_torch/ft/checkpoint.py``), so a restart may come back on another
device count; ``elastic_remesh_plan`` records the transition.

The straggler monitor covers the host-side hazards of a training job
(slow data feeding, slow checkpoint writes): batches come from a bounded
prefetch queue with a timeout; on timeout the loop takes the
deterministic backup batch (skip-and-refill) instead of stalling the
device, and counts the event.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterator


class SimulatedFailure(RuntimeError):
    """Raised by failure injection hooks (tests / chaos drills)."""


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    completed: bool = False
    resume_steps: list[int] = dataclasses.field(default_factory=list)


class RestartManager:
    """Run ``body(resume_step) -> final_step`` with bounded-retry restart.

    ``body`` must itself restore from the latest checkpoint when called with
    a resume step > 0 (see launch/train.py); the manager only supervises.
    """

    def __init__(self, max_restarts: int = 3,
                 resume_step_fn: Callable[[], int] | None = None):
        self.max_restarts = max_restarts
        self.resume_step_fn = resume_step_fn or (lambda: 0)
        self.stats = RestartStats()

    def run(self, body: Callable[[int], Any]):
        attempt = 0
        while True:
            resume = self.resume_step_fn()
            self.stats.resume_steps.append(resume)
            try:
                result = body(resume)
                self.stats.completed = True
                return result
            except SimulatedFailure:
                attempt += 1
                self.stats.restarts += 1
                if attempt > self.max_restarts:
                    raise


class FailureInjector:
    """Deterministically fail at configured steps (once each)."""

    def __init__(self, fail_at_steps: tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerStats:
    timeouts: int = 0
    served: int = 0


class PrefetchQueue:
    """Bounded producer/consumer prefetch with straggler mitigation.

    ``get`` waits up to ``timeout_s``; on timeout it returns
    ``backup_fn(step)`` (deterministic synthetic batch) instead of stalling
    the accelerator — the skip-and-refill policy.
    """

    def __init__(self, it: Iterator, *, depth: int = 4, timeout_s: float = 5.0,
                 backup_fn: Callable[[int], Any] | None = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self.timeout_s = timeout_s
        self.backup_fn = backup_fn
        self.stats = StragglerStats()
        self._done = False
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._done = True

    def get(self, step: int):
        try:
            item = self._q.get(timeout=self.timeout_s)
            self.stats.served += 1
            return item
        except queue.Empty:
            self.stats.timeouts += 1
            if self.backup_fn is None:
                raise TimeoutError(
                    f"data pipeline straggled > {self.timeout_s}s at step "
                    f"{step} and no backup batch is configured")
            return self.backup_fn(step)


def elastic_remesh_plan(old_devices: int, new_devices: int,
                        model_parallel: int) -> dict:
    """Describe how a checkpoint written on ``old_devices`` is re-laid-out
    on ``new_devices`` (full-array checkpoints make this a pure metadata
    decision: only the data-parallel extent changes)."""
    if new_devices % model_parallel != 0:
        raise ValueError(
            f"new device count {new_devices} not divisible by "
            f"model-parallel degree {model_parallel}")
    return {
        "old_dp": old_devices // model_parallel,
        "new_dp": new_devices // model_parallel,
        "model_parallel": model_parallel,
        "batch_ratio": new_devices / old_devices,
    }
