"""Async request queue over the wave slot pool (DESIGN §2.10), the port of
``repro/serve/queue.py``.

The serving tier so far is call-at-a-time: every
:meth:`GraphSessionManager.levels` call builds its own wave, so queries
that arrive milliseconds apart never share a level step.  This module adds
the asynchronous half the ROADMAP names (fpgagraphlib's arbiter / network /
barrier split, re-cast onto the wave machinery):

* :class:`RequestQueue` — the **arbiter**: non-blocking ``submit`` returns
  a :class:`WaveFuture`; admission is bounded (global ``capacity``, per-
  tenant ``tenant_backlog``) and refusals raise
  :class:`~repro_torch.errors.QueueFullError` at ingress instead of growing an
  unbounded backlog, the same fail-fast contract as the manager's
  :class:`~repro_torch.errors.AdmissionError`.
* :class:`WaveScheduler` — the **network**: one drain pass per session
  translates the queue into :func:`~repro_torch.core.multi_source.drive_wave`'s
  refill hook, so arrivals coalesce into free slots of a wave ALREADY IN
  FLIGHT (``drive_wave`` re-offers every free slot after every lock-step
  level — that mid-flight refill is the entire throughput story: late
  arrivals share every remaining adjacency read of the current wave).
* the **barrier** is the wave's own convergence: each column resolves its
  future the moment its frontier empties, and post-wave the batch is
  cross-checked through the manager's verify hook
  (:meth:`GraphSessionManager.verify_wave`) so the fault-injection
  gauntlet drains to *degraded-but-correct* answers, never wrong ones.

Scheduling respects the manager's tenant model: slots are handed out
round-robin across tenants (a bursty tenant cannot starve the others) and
a tenant's in-wave slot share is capped by its
:class:`~repro_torch.serve.session_manager.TenantQuota` ``max_inflight``.
Deadlines are per REQUEST, measured from submission on the queue's clock —
queue wait counts against the budget — and an over-deadline request is
harvested mid-flight into a partial
:class:`~repro_torch.serve.session_manager.TimeoutResult` exactly like the
synchronous path.

The queue is thread-safe: ``submit`` may race ``drain`` (or the
``start()`` background pump) from any thread; the wave hooks only ever run
on the draining thread.  On the card that thread launches the kernels on
its current stream (the pump's is the default stream), and each wave
first synchronises the session's device, so state another thread prepared
on any stream is complete before the wave reads it.  Each wave and its
verification hold the manager's serving lock, so an edge update
(:meth:`GraphSessionManager.update_edges`) from another thread lands
between waves, never inside one.

On a mesh session every rank runs its own queue (SPMD): each rank submits
the same requests in the same order, so their request ids agree, and
drains them.  A wave's refills follow rank 0: rank 0 picks each request
by the tenant-fair rule on its own clock, and the other ranks take the
request with the same id, waiting for their own submission of it if it
has not been made yet; ``drive_wave`` makes the deadline harvests rank
0's too.  A rank's pump may start a wave before rank 0's does; it then
waits in the wave's first collective.  Every mesh session of a queue
shares the process group, so a queue serves one mesh session.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.bfs import rank_layout
from repro_torch.core.multi_source import drive_wave, leader_agreement
from repro_torch.errors import QueueFullError, check_source
from repro_torch.serve.session_manager import GraphSessionManager

__all__ = ["WaveFuture", "RequestQueue", "WaveScheduler"]


class WaveFuture:
    """Handle for one queued query: resolves to the caller-id level array,
    a partial :class:`~repro_torch.serve.session_manager.TimeoutResult`
    (deadline harvest), or re-raises the error that killed the request."""

    def __init__(self, request_id: int, session: str, tenant: str,
                 source: int):
        self.request_id = request_id
        self.session = session
        self.tenant = tenant
        self.source = source
        self._done = threading.Event()
        self._value: Any = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        """Block until resolved (``TimeoutError`` if ``timeout`` elapses
        first — the request itself stays queued and may still resolve)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} (source {self.source} on "
                f"session {self.session!r}) not resolved in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: float | None = None
                  ) -> BaseException | None:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not resolved in {timeout}s")
        return self._error

    # -- resolution (scheduler side) -----------------------------------
    def _resolve(self, value) -> None:
        self._value = value
        self._done.set()

    def _reject(self, error: BaseException) -> None:
        self._error = error
        self._done.set()


class _Request:
    """One queued query: the future plus its scheduling envelope."""

    __slots__ = ("future", "src", "tenant", "submitted_at", "not_before",
                 "deadline_s")

    def __init__(self, future: WaveFuture, src: int, tenant: str,
                 submitted_at: float, not_before: float | None,
                 deadline_s: float | None):
        self.future = future
        self.src = src
        self.tenant = tenant
        self.submitted_at = submitted_at
        self.not_before = not_before
        self.deadline_s = deadline_s


class _SessionQueue:
    """Per-session pending pool: one FIFO per tenant + a round-robin ring
    over the tenants, so slot hand-out is tenant-fair by construction."""

    def __init__(self) -> None:
        self.tenants: dict[str, deque[_Request]] = {}
        self.ring: deque[str] = deque()

    def push(self, req: _Request) -> None:
        q = self.tenants.get(req.tenant)
        if q is None:
            q = self.tenants[req.tenant] = deque()
            self.ring.append(req.tenant)
        q.append(req)

    def __len__(self) -> int:
        return sum(len(q) for q in self.tenants.values())

    def pop_fair(self, now: float, slot_share: dict[str, int],
                 cap_of: Callable[[str], int | None]) -> _Request | None:
        """Next eligible request, rotating the tenant ring: skips tenants
        at their ``max_inflight`` slot share and requests whose
        ``not_before`` is still in the future."""
        for _ in range(len(self.ring)):
            tenant = self.ring[0]
            self.ring.rotate(-1)
            cap = cap_of(tenant)
            if cap is not None and slot_share.get(tenant, 0) >= cap:
                continue
            q = self.tenants[tenant]
            for i, req in enumerate(q):
                if req.not_before is None or req.not_before <= now:
                    del q[i]
                    return req
        return None

    def eligible(self, now: float) -> bool:
        return any(r.not_before is None or r.not_before <= now
                   for q in self.tenants.values() for r in q)

    def next_not_before(self) -> float | None:
        times = [r.not_before for q in self.tenants.values() for r in q
                 if r.not_before is not None]
        return min(times) if times else None

    def take(self, request_id: int) -> _Request | None:
        """Remove and return the request with this id, if it is here."""
        for q in self.tenants.values():
            for i, req in enumerate(q):
                if req.future.request_id == request_id:
                    del q[i]
                    return req
        return None

    def drain_all(self) -> list[_Request]:
        out = [r for q in self.tenants.values() for r in q]
        for q in self.tenants.values():
            q.clear()
        return out


class RequestQueue:
    """Bounded async ingress in front of a
    :class:`~repro_torch.serve.session_manager.GraphSessionManager`.

    Parameters
    ----------
    manager:
        The session manager whose sessions, tenant quotas and verify
        policy the queue serves under.
    capacity:
        Global pending-request bound; a submit past it raises
        :class:`~repro_torch.errors.QueueFullError` (reason ``"capacity"``).
    tenant_backlog:
        Per-tenant pending bound (reason ``"tenant-backlog"``); ``None``
        leaves tenants bounded only by ``capacity``.
    clock:
        Monotonic time source (injectable for tests); deadlines and
        ``not_before`` are measured on it.
    """

    def __init__(self, manager: GraphSessionManager, *,
                 capacity: int = 1024, tenant_backlog: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.manager = manager
        self.capacity = int(capacity)
        self.tenant_backlog = tenant_backlog
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: dict[str, _SessionQueue] = {}
        self._n_pending = 0
        self._n_tenant: dict[str, int] = {}
        self._ids = itertools.count()
        self._stats = {"submitted": 0, "completed": 0, "timeouts": 0,
                       "degraded": 0, "rejected": 0, "coalesced": 0,
                       "waves": 0}
        self.events: list[dict[str, Any]] = []
        self._pump: threading.Thread | None = None
        self._stop = threading.Event()
        self._wake = threading.Event()

    # ------------------------------------------------------------------
    # ingress
    # ------------------------------------------------------------------
    def submit(self, name: str, src: int, *, tenant: str = "default",
               deadline_s: float | None = None,
               not_before: float | None = None) -> WaveFuture:
        """Enqueue one level query, non-blocking; returns the future.

        ``deadline_s`` is the request's total latency budget from NOW
        (queue wait included); ``not_before`` (a ``clock()`` timestamp)
        holds the request back until that instant — the simulated-arrival
        hook of the Poisson benchmark, so arrival patterns are replayable
        without wall-clock sleeps on the submitting side."""
        rec = self.manager._get(name, tenant)   # validates name + tenant
        src = check_source(src, rec.session.n)
        with self._lock:
            if self._n_pending >= self.capacity:
                self._stats["rejected"] += 1
                self._event("reject", reason="capacity", session=name,
                            tenant=tenant)
                raise QueueFullError(
                    f"queue at capacity ({self.capacity} pending)",
                    reason="capacity")
            if self.tenant_backlog is not None and \
                    self._n_tenant.get(tenant, 0) >= self.tenant_backlog:
                self._stats["rejected"] += 1
                self._event("reject", reason="tenant-backlog",
                            session=name, tenant=tenant)
                raise QueueFullError(
                    f"tenant {tenant!r} holds "
                    f"{self._n_tenant[tenant]} pending requests "
                    f"(backlog cap {self.tenant_backlog})",
                    reason="tenant-backlog")
            fut = WaveFuture(next(self._ids), name, tenant, src)
            req = _Request(fut, src, tenant, self._clock(), not_before,
                           deadline_s)
            self._pending.setdefault(name, _SessionQueue()).push(req)
            self._n_pending += 1
            self._n_tenant[tenant] = self._n_tenant.get(tenant, 0) + 1
            self._stats["submitted"] += 1
        self._wake.set()
        return fut

    def _event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, **fields})

    def _checkout(self, name: str, now: float, slot_share: dict[str, int],
                  cap_of) -> _Request | None:
        with self._lock:
            sq = self._pending.get(name)
            if sq is None:
                return None
            req = sq.pop_fair(now, slot_share, cap_of)
            if req is not None:
                self._n_pending -= 1
                self._n_tenant[req.tenant] -= 1
            return req

    def _checkout_id(self, name: str, request_id: int,
                     poll_s: float = 0.0005) -> _Request:
        """Remove request ``request_id`` of session ``name`` from the
        pending pool, waiting for its submission if this rank has not
        made it yet (a mesh rank following rank 0's pick)."""
        while True:
            with self._lock:
                sq = self._pending.get(name)
                req = sq.take(request_id) if sq is not None else None
                if req is not None:
                    self._n_pending -= 1
                    self._n_tenant[req.tenant] -= 1
                    return req
            time.sleep(poll_s)

    @property
    def pending(self) -> int:
        with self._lock:
            return self._n_pending

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._stats, pending=self._n_pending)

    # ------------------------------------------------------------------
    # draining
    # ------------------------------------------------------------------
    def drain(self, *, wait: bool = False, poll_s: float = 0.0005) -> int:
        """Pump waves until the queue is empty; returns requests resolved.

        One :class:`WaveScheduler` pass per session with eligible work;
        sessions round-robin between waves.  ``wait=True`` additionally
        sleeps through ``not_before`` gaps (simulated arrivals) instead of
        returning while future-dated requests remain."""
        resolved = 0
        while True:
            with self._lock:
                now = self._clock()
                names = [cand for cand, sq in self._pending.items()
                         if sq.eligible(now)]
                empty = self._n_pending == 0
            if names:
                # one wave per eligible session per pass: a session with a
                # standing backlog cannot starve the others
                for name in names:
                    resolved += WaveScheduler(self, name).run()
                continue
            if empty or not wait:
                return resolved
            with self._lock:
                nb = [sq.next_not_before()
                      for sq in self._pending.values()]
                nb = [t for t in nb if t is not None]
            delay = max(min(nb) - self._clock(), 0.0) if nb else poll_s
            time.sleep(min(max(delay, 0.0), 0.05))

    def start(self, *, poll_s: float = 0.002) -> None:
        """Spawn the background drain pump (daemon thread): submissions
        resolve without any caller ever touching :meth:`drain`."""
        if self._pump is not None:
            return
        self._stop.clear()

        def pump() -> None:
            while not self._stop.is_set():
                self._wake.wait(poll_s)
                self._wake.clear()
                self.drain(wait=False)

        self._pump = threading.Thread(target=pump, name="wave-queue-pump",
                                      daemon=True)
        self._pump.start()

    def stop(self, *, drain: bool = True) -> None:
        """Stop the pump; by default drain what is still queued first."""
        if self._pump is None:
            return
        self._stop.set()
        self._wake.set()
        self._pump.join()
        self._pump = None
        if drain:
            self.drain(wait=True)


class WaveScheduler:
    """One drain pass of one session: the queue-to-wave adapter.

    Translates the pending pool into ``drive_wave``'s hooks — tenant-fair
    refill (``next_source``), per-request deadline harvest, future
    resolution on convergence — then runs the manager's verify hook over
    the completed batch so injected faults degrade instead of lying.
    """

    def __init__(self, queue: RequestQueue, name: str):
        self.queue = queue
        self.name = name

    def run(self) -> int:
        q = self.queue
        mgr = q.manager
        try:
            rec = mgr._get(self.name, self._any_tenant())
        except Exception as e:
            # the session vanished between submit and drain (closed, or
            # LRU-evicted): fail its backlog loudly, don't dangle futures
            return self._reject_all(e)
        if rec.quarantined:
            return self._drain_degraded(rec)
        # an epoch swap (manager.update_edges) waits for the whole wave and
        # its verification, so both run on one epoch
        with mgr._serve_lock:
            return self._wave(rec)

    def _wave(self, rec) -> int:
        q = self.queue
        mgr = q.manager
        sess = rec.session
        perm = sess.perm
        S = sess.max_batch
        owner: list[_Request | None] = [None] * S
        slot_share: dict[str, int] = {}
        completed: list[tuple[_Request, np.ndarray]] = []
        timeouts: list[tuple[_Request, np.ndarray]] = []

        def cap_of(tenant: str) -> int | None:
            return mgr.quota_for(tenant).max_inflight

        # on a mesh every rank drains its own queue of the same requests
        # (SPMD), and the wave's refills must match: rank 0 picks, and
        # the other ranks take the request with rank 0's id
        agree = leader_agreement(sess._ms)
        leader = agree is None or rank_layout(sess._problem).leader

        def next_source(slot: int) -> int | None:
            req = q._checkout(self.name, q._clock(), slot_share, cap_of) \
                if leader else None
            if agree is not None:
                rid = agree([-1 if req is None
                             else req.future.request_id])[0]
                if not leader and rid >= 0:
                    req = q._checkout_id(self.name, rid)
            if req is None:
                return None
            if any(o is not None for o in owner):
                # the wave is already in flight: this arrival shares its
                # remaining level steps — the coalescing win the bench
                # floors (queue.summary geomean)
                q._stats["coalesced"] += 1
            owner[slot] = req
            slot_share[req.tenant] = slot_share.get(req.tenant, 0) + 1
            return int(perm[req.src])

        def release(slot: int) -> _Request:
            req = owner[slot]
            owner[slot] = None
            slot_share[req.tenant] -= 1
            return req

        def on_converged(slot: int, lv: np.ndarray) -> None:
            completed.append((release(slot), lv[perm]))

        def should_harvest(slot: int) -> bool:
            req = owner[slot]
            return (req is not None and req.deadline_s is not None
                    and q._clock() - req.submitted_at > req.deadline_s)

        def on_harvested(slot: int, lv: np.ndarray) -> None:
            timeouts.append((release(slot), lv[perm]))

        limit = sess.max_steps if sess.max_steps is not None else \
            (q.capacity + S) * (sess.n + 1)
        device = sess._problem.device
        if device.type == "cuda":
            # the session may have been prepared on another thread's stream
            torch.cuda.synchronize(device)
        try:
            drive_wave(sess._ms, next_source, on_converged,
                       max_steps=limit, should_harvest=should_harvest,
                       on_harvested=on_harvested)
        except Exception as e:
            for slot in range(S):       # never leave a future dangling
                if owner[slot] is not None:
                    release(slot).future._reject(e)
            raise
        rec.served += len(completed)

        # post-wave verify: on divergence the manager quarantines and the
        # WHOLE batch re-serves on the reference path (degraded-correct)
        refs = None
        if completed:
            refs = mgr.verify_wave(self.name,
                                   [r.src for r, _ in completed],
                                   [lv for _, lv in completed],
                                   tenant=rec.tenant)
        if refs is not None:
            q._stats["degraded"] += len(completed)
            q._event("degraded", session=self.name, n=len(completed))
            for (req, _), ref_lv in zip(completed, refs):
                req.future._resolve(ref_lv)
        else:
            for req, lv in completed:
                req.future._resolve(lv)
        for req, lv in timeouts:
            q._stats["timeouts"] += 1
            q._event("timeout", session=self.name, tenant=req.tenant,
                     source=req.src, deadline_s=req.deadline_s)
            req.future._resolve(GraphSessionManager._timeout_result(
                req.src, lv, req.deadline_s))
        q._stats["completed"] += len(completed) + len(timeouts)
        q._stats["waves"] += 1
        return len(completed) + len(timeouts)

    def _any_tenant(self) -> str:
        with self.queue._lock:
            sq = self.queue._pending.get(self.name)
            if sq is not None:
                for tenant, dq in sq.tenants.items():
                    if dq:
                        return tenant
        return "default"

    def _reject_all(self, error: BaseException) -> int:
        q = self.queue
        with q._lock:
            sq = q._pending.pop(self.name, None)
            reqs = sq.drain_all() if sq is not None else []
            for req in reqs:
                q._n_pending -= 1
                q._n_tenant[req.tenant] -= 1
        for req in reqs:
            req.future._reject(error)
        if reqs:
            q._event("reject-backlog", session=self.name, n=len(reqs),
                     error=type(error).__name__)
        return 0

    def _drain_degraded(self, rec) -> int:
        """A quarantined session's backlog resolves on the reference path
        immediately — no wave, no partials, still correct answers."""
        q = self.queue
        with q._lock:
            sq = q._pending.get(self.name)
            reqs = sq.drain_all() if sq is not None else []
            for req in reqs:
                q._n_pending -= 1
                q._n_tenant[req.tenant] -= 1
        if not reqs:
            return 0
        refs = q.manager._serve_reference(rec, [r.src for r in reqs])
        for req, lv in zip(reqs, refs):
            req.future._resolve(lv)
        q._stats["degraded"] += len(reqs)
        q._stats["completed"] += len(reqs)
        q._event("degraded", session=self.name, n=len(reqs))
        return len(reqs)
