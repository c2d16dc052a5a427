"""GraphSessionManager: the hardened multi-tenant serving tier
(DESIGN §2.7), the port of ``repro/serve/session_manager.py``.

One manager fronts MANY prepared graphs for MANY tenants, adding the
robustness layer a single
:class:`~repro_torch.serve.graph_session.GraphSession` does not have:

* **Byte-budgeted LRU of prepared state.**  Each open session is costed
  with the DESIGN §2.5 memory model (``bvss.memory_bytes()`` + the
  O(n·S) wave state); opening a session past the global ``byte_budget``
  evicts least-recently-used sessions until the new one fits, and raises
  :class:`~repro_torch.errors.AdmissionError` (reason ``"byte-budget"``)
  when it cannot — never a hang, never an OOM surprise.
* **Per-tenant quotas and admission control.**  A :class:`TenantQuota`
  caps open sessions, prepared bytes and per-call batch width per
  tenant; violations are rejected with a machine-readable reason
  (``"tenant-sessions"`` / ``"tenant-bytes"`` / ``"inflight"`` /
  ``"unknown-session"``), not queued behind an unbounded backlog.
* **Per-request deadlines.**  ``levels_batch(..., deadline_s=...)``
  threads the wave loop's cancellation hooks: a query that outlives its
  budget is harvested mid-flight at the next lock-step level, its slot
  refilled, and a partial :class:`TimeoutResult` (levels so far + the
  deepest completed frontier) returned — one slow query cannot block the
  wave.  ``on_deadline="raise"`` turns the partial into a
  :class:`~repro_torch.errors.DeadlineExceeded` for callers that need
  all-or-nothing semantics.
* **Verify-mode sampling, quarantine, graceful degradation.**  A
  configurable fraction of completed wave results is cross-checked
  against the ``kernels/ref.py`` host oracles; a divergence (e.g. an
  injected :class:`~repro_torch.serve.faults.FaultPlan` corruption)
  raises :class:`~repro_torch.errors.KernelFaultError` internally,
  QUARANTINES the session, re-serves the whole call on the reference
  path and emits a :class:`DegradedServiceWarning` — callers always get
  correct levels, possibly slowly, never silently wrong ones.  Analytics
  verbs carry a finite guard: NaN-poisoned σ channels degrade to
  ``betweenness_ref`` / ``closeness_ref`` the same way.

* **Streaming edge updates.**  ``update_edges`` swaps a session to its
  next epoch (DESIGN §2.10) and refreshes the manager's oracle graph and
  the session's byte cost with it.  One re-entrant lock serialises the
  swap with serving: a wave of ``levels_batch`` or of the
  :class:`~repro_torch.serve.queue.RequestQueue`'s pump thread, with its
  verification, runs whole on one epoch, so verify mode never holds an
  old epoch's answer against the new graph.

Every admission decision, eviction, timeout, quarantine and degradation
is appended to ``manager.events`` (structured dicts) and aggregated by
``manager.stats()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core.bfs import INF, reference_bfs
from repro_torch.errors import (AdmissionError, DeadlineExceeded,
                                KernelFaultError, check_sources)
from repro_torch.graphs import Graph, from_edges, src_of_edges
from repro_torch.kernels.ref import betweenness_ref, closeness_ref
from repro_torch.serve.graph_session import GraphSession


class DegradedServiceWarning(UserWarning):
    """The manager served a degraded (reference-path / partial) answer."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits (``None`` = unlimited)."""

    max_sessions: int | None = None   # concurrently open sessions
    max_bytes: int | None = None      # prepared bytes across its sessions
    max_inflight: int | None = None   # sources per levels_batch call


@dataclasses.dataclass(frozen=True)
class TimeoutResult:
    """Partial answer for a query harvested at its deadline.

    ``levels`` holds caller-id levels computed before the harvest
    (``INF`` = not yet reached); ``depth`` is the deepest completed
    level and ``frontier`` the caller-id vertices discovered at it —
    enough state for the caller to resume or refine the query."""

    source: int
    levels: np.ndarray
    depth: int
    frontier: np.ndarray
    deadline_s: float | None

    @property
    def complete(self) -> bool:
        return False


@dataclasses.dataclass
class _SessionRecord:
    name: str
    tenant: str
    graph: Graph                  # the caller's ORIGINAL graph (oracle input)
    session: GraphSession
    cost_bytes: int
    quarantined: bool = False
    quarantine_reason: str | None = None
    served: int = 0


def session_cost_bytes(session: GraphSession) -> int:
    """DESIGN §2.5 memory model of one prepared session: the BVSS
    footprint breakdown plus the O(n·S) wave state (levels + packed
    frontier words, S = ``max_batch`` stacked columns)."""
    mem = session.bvss.memory_bytes()
    S = session.max_batch
    wave = 4 * (session.n + 1) * S + 4 * session.bvss.n_frontier_words * S
    return int(mem["total"]) + int(wave)


class GraphSessionManager:
    """Multi-tenant, byte-budgeted, deadline-aware front over many
    :class:`GraphSession`\\ s.

    Parameters
    ----------
    byte_budget:
        Global cap (bytes, DESIGN §2.5 model) on prepared state across
        all sessions; LRU sessions are evicted to make room.  ``None``
        disables eviction.
    default_quota:
        The :class:`TenantQuota` applied to tenants without an explicit
        ``set_quota`` entry.
    verify_fraction:
        Fraction (0..1) of completed wave results cross-checked against
        the host oracle; 1.0 checks every result (the chaos-gauntlet
        setting), 0.0 disables verification.
    verify_seed:
        Seed of the sampling RNG (deterministic verification schedule).
    clock:
        Monotonic time source, injectable for tests.
    """

    def __init__(self, *, byte_budget: int | None = None,
                 default_quota: TenantQuota = TenantQuota(),
                 verify_fraction: float = 0.0, verify_seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 <= verify_fraction <= 1.0:
            raise ValueError(
                f"verify_fraction must be in [0, 1], got {verify_fraction}")
        self.byte_budget = byte_budget
        self.default_quota = default_quota
        self.verify_fraction = float(verify_fraction)
        self._verify_rng = np.random.default_rng(verify_seed)
        self._clock = clock
        self._sessions: OrderedDict[str, _SessionRecord] = OrderedDict()
        self._quotas: dict[str, TenantQuota] = {}
        self.events: list[dict[str, Any]] = []
        # held by an epoch swap and around every wave and its verification
        # (re-entrant: a queue wave verifies through verify_wave)
        self._serve_lock = threading.RLock()

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, **fields})

    def quota_for(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self.default_quota)

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        self._quotas[tenant] = quota

    def bytes_used(self) -> int:
        return sum(r.cost_bytes for r in self._sessions.values())

    def _tenant_records(self, tenant: str) -> list[_SessionRecord]:
        return [r for r in self._sessions.values() if r.tenant == tenant]

    def _get(self, name: str, tenant: str) -> _SessionRecord:
        rec = self._sessions.get(name)
        if rec is None:
            raise AdmissionError(f"no open session named {name!r}",
                                 reason="unknown-session")
        if rec.tenant != tenant:
            # tenant isolation: another tenant's session name is
            # indistinguishable from a missing one
            raise AdmissionError(
                f"no open session named {name!r} for tenant {tenant!r}",
                reason="unknown-session")
        self._sessions.move_to_end(name)       # LRU touch
        return rec

    # ------------------------------------------------------------------
    # session lifecycle
    # ------------------------------------------------------------------
    def open_session(self, name: str, g: Graph, *, tenant: str = "default",
                     mesh=None, **session_kwargs
                     ) -> GraphSession:
        """Prepare ``g`` and admit it as session ``name`` for ``tenant``.

        Admission order: tenant session-count quota (pre-build, cheap) →
        build → exact byte cost → tenant byte quota (hard reject) →
        global byte budget (LRU-evict to fit, reject if impossible).
        Rejections raise :class:`AdmissionError` with a reason code; the
        build is discarded, never half-registered."""
        if name in self._sessions:
            raise AdmissionError(
                f"session name {name!r} is already open "
                f"(close it first or pick another name)",
                reason="duplicate-name")
        quota = self.quota_for(tenant)
        mine = self._tenant_records(tenant)
        if (quota.max_sessions is not None
                and len(mine) >= quota.max_sessions):
            self._event("admission-reject", tenant=tenant, name=name,
                        reason="tenant-sessions")
            raise AdmissionError(
                f"tenant {tenant!r} already has {len(mine)} open sessions "
                f"(quota {quota.max_sessions})", reason="tenant-sessions")
        session = GraphSession(g, mesh=mesh, **session_kwargs)
        cost = session_cost_bytes(session)
        if quota.max_bytes is not None:
            used = sum(r.cost_bytes for r in mine)
            if used + cost > quota.max_bytes:
                self._event("admission-reject", tenant=tenant, name=name,
                            reason="tenant-bytes")
                raise AdmissionError(
                    f"session {name!r} needs {cost} bytes; tenant "
                    f"{tenant!r} holds {used} of {quota.max_bytes}",
                    reason="tenant-bytes")
        if self.byte_budget is not None:
            if cost > self.byte_budget:
                self._event("admission-reject", tenant=tenant, name=name,
                            reason="byte-budget")
                raise AdmissionError(
                    f"session {name!r} needs {cost} bytes, over the "
                    f"global budget of {self.byte_budget}",
                    reason="byte-budget")
            while self.bytes_used() + cost > self.byte_budget:
                lru_name, lru = next(iter(self._sessions.items()))
                del self._sessions[lru_name]
                self._event("evict", name=lru_name, tenant=lru.tenant,
                            freed_bytes=lru.cost_bytes)
        rec = _SessionRecord(name=name, tenant=tenant, graph=g,
                             session=session, cost_bytes=cost)
        self._sessions[name] = rec
        self._event("open", name=name, tenant=tenant, bytes=cost)
        return session

    def close_session(self, name: str, *, tenant: str = "default") -> None:
        rec = self._get(name, tenant)
        del self._sessions[name]
        self._event("close", name=name, tenant=tenant,
                    freed_bytes=rec.cost_bytes)

    def __contains__(self, name: str) -> bool:
        return name in self._sessions

    # ------------------------------------------------------------------
    # streaming updates (DESIGN §2.10)
    # ------------------------------------------------------------------
    def update_edges(self, name: str, inserts=(), deletes=(), *,
                     tenant: str = "default", insert_weights=None,
                     expected_epoch: int | None = None,
                     staleness_budget: int | None = None):
        """Apply a streaming edge-update batch to session ``name`` and
        swap it to the next epoch; returns the
        :class:`~repro_torch.core.bvss_delta.UpdateReport` (``None`` for an
        effective no-op).  The manager's oracle copy of the graph and the
        session's byte cost follow the update, so verify-mode sampling
        and the LRU budget stay truthful about the mutated graph.  The
        swap waits for a wave in flight on another thread (the queue's
        pump) to finish and be verified on the old epoch."""
        rec = self._get(name, tenant)
        with self._serve_lock:
            report = rec.session.update_edges(
                inserts, deletes, insert_weights=insert_weights,
                expected_epoch=expected_epoch,
                staleness_budget=staleness_budget)
            if report is None:
                return None
            # refresh the ORIGINAL-id oracle graph from the mutated session
            p = rec.session.prepared
            src_o = p.inv[src_of_edges(p.graph).astype(np.int64)]
            dst_o = p.inv[p.graph.indices.astype(np.int64)]
            rec.graph = from_edges(p.graph.n, src_o, dst_o, dedup=True,
                                   drop_loops=False)
            rec.cost_bytes = session_cost_bytes(rec.session)
        self._event("update-edges", name=name, tenant=tenant,
                    path=report.path, epoch=report.epoch,
                    n_inserted=report.n_inserted,
                    n_deleted=report.n_deleted)
        return report

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def levels(self, name: str, src: int, *, tenant: str = "default",
               deadline_s: float | None = None,
               on_deadline: str = "partial"
               ) -> np.ndarray | TimeoutResult:
        """Single level query (see :meth:`levels_batch`).  With a
        deadline the query rides the wave pool — the fused singleton
        engine cannot be preempted mid-flight."""
        return self.levels_batch(name, [src], tenant=tenant,
                                 deadline_s=deadline_s,
                                 on_deadline=on_deadline)[0]

    def levels_batch(self, name: str, sources: Sequence[int], *,
                     tenant: str = "default",
                     deadline_s: float | None = None,
                     on_deadline: str = "partial"
                     ) -> list[np.ndarray | TimeoutResult]:
        """Batched level queries with admission, deadlines and verify.

        Returns one entry per source: a caller-id level array, or a
        :class:`TimeoutResult` for a query harvested at ``deadline_s``
        (wall-clock seconds for the WHOLE call, measured on the
        manager's clock; cancellation granularity is one lock-step
        level).  ``on_deadline="raise"`` raises
        :class:`DeadlineExceeded` instead of returning partials.  A
        quarantined session serves on the reference path with a
        :class:`DegradedServiceWarning`."""
        if on_deadline not in ("partial", "raise"):
            raise ValueError(
                f"on_deadline must be 'partial' or 'raise', "
                f"got {on_deadline!r}")
        rec = self._get(name, tenant)
        srcs = check_sources(sources, rec.session.n)
        quota = self.quota_for(tenant)
        if (quota.max_inflight is not None
                and len(srcs) > quota.max_inflight):
            self._event("admission-reject", tenant=tenant, name=name,
                        reason="inflight")
            raise AdmissionError(
                f"{len(srcs)} sources exceed tenant {tenant!r}'s "
                f"in-flight cap of {quota.max_inflight}",
                reason="inflight")
        if not srcs:
            return []
        if rec.quarantined:
            return self._serve_reference(rec, srcs)
        rec.served += len(srcs)

        partials: dict[int, np.ndarray] = {}
        with self._serve_lock:       # one epoch for the wave and its verify
            if deadline_s is None:
                outs = rec.session.levels_batch(srcs)
            else:
                t0 = self._clock()

                def should_harvest(i: int) -> bool:
                    return self._clock() - t0 > deadline_s

                def on_harvested(i: int, lv: np.ndarray) -> None:
                    partials[i] = lv

                outs = rec.session.levels_batch(
                    srcs, should_harvest=should_harvest,
                    on_harvested=on_harvested)

            # verify-mode sampling on the COMPLETED results
            try:
                self._verify(rec, srcs, outs)
            except KernelFaultError as e:
                self._quarantine(rec, str(e))
                return self._serve_reference(rec, srcs)

        results: list[np.ndarray | TimeoutResult] = []
        for i, (s, lv) in enumerate(zip(srcs, outs)):
            if lv is not None:
                results.append(lv)
                continue
            if on_deadline == "raise":
                raise DeadlineExceeded(
                    f"query for source {s} on session {name!r} exceeded "
                    f"its {deadline_s}s deadline")
            self._event("timeout", name=name, tenant=tenant, source=s,
                        deadline_s=deadline_s)
            warnings.warn(
                f"session {name!r}: source {s} harvested at its "
                f"{deadline_s}s deadline; returning partial levels",
                DegradedServiceWarning, stacklevel=2)
            results.append(self._timeout_result(s, partials[i], deadline_s))
        return results

    @staticmethod
    def _timeout_result(src: int, lv: np.ndarray,
                        deadline_s: float | None) -> TimeoutResult:
        finite = lv != INF
        depth = int(lv[finite].max()) if finite.any() else 0
        return TimeoutResult(source=int(src), levels=lv, depth=depth,
                             frontier=np.flatnonzero(lv == depth),
                             deadline_s=deadline_s)

    # ------------------------------------------------------------------
    # verification / quarantine / degradation
    # ------------------------------------------------------------------
    def verify_wave(self, name: str, sources: Sequence[int],
                    results: Sequence[np.ndarray], *,
                    tenant: str = "default") -> list[np.ndarray] | None:
        """Public verify hook for EXTERNAL wave drivers (the async
        :class:`~repro_torch.serve.queue.RequestQueue`): cross-check a
        completed batch under this manager's ``verify_fraction`` sampling
        policy.

        Returns ``None`` when the batch passes (or verification is off).
        On a divergence the session is quarantined and the WHOLE batch is
        re-served on the reference path — the returned list (one caller-id
        level array per source) is what the driver must hand out instead
        of the device results."""
        rec = self._get(name, tenant)
        try:
            self._verify(rec, list(sources), list(results))
        except KernelFaultError as e:
            self._quarantine(rec, str(e))
            return self._serve_reference(rec, list(sources))
        return None

    def _verify(self, rec: _SessionRecord, srcs: list[int],
                outs: list[np.ndarray | None]) -> None:
        """Cross-check a sampled fraction of completed results against
        the host oracle; raise :class:`KernelFaultError` on divergence."""
        if self.verify_fraction <= 0.0:
            return
        for s, lv in zip(srcs, outs):
            if lv is None:
                continue
            if self._verify_rng.random() >= self.verify_fraction:
                continue
            want = reference_bfs(rec.graph, s)
            if not np.array_equal(np.asarray(lv), want):
                bad = int(np.flatnonzero(np.asarray(lv) != want)[0])
                raise KernelFaultError(
                    f"session {rec.name!r}: levels from source {s} "
                    f"diverge from the oracle (first at vertex {bad})")
            self._event("verify-pass", name=rec.name, source=s)

    def _quarantine(self, rec: _SessionRecord, reason: str) -> None:
        rec.quarantined = True
        rec.quarantine_reason = reason
        self._event("quarantine", name=rec.name, tenant=rec.tenant,
                    reason=reason)
        warnings.warn(
            f"session {rec.name!r} quarantined after failed kernel "
            f"verification ({reason}); serving on the reference path",
            DegradedServiceWarning, stacklevel=3)

    def _serve_reference(self, rec: _SessionRecord, srcs: list[int]
                         ) -> list[np.ndarray]:
        """Degraded-but-correct: host-oracle BFS per source."""
        self._event("degraded-serve", name=rec.name, tenant=rec.tenant,
                    n_queries=len(srcs))
        warnings.warn(
            f"session {rec.name!r} is quarantined "
            f"({rec.quarantine_reason}); serving {len(srcs)} queries on "
            f"the reference path", DegradedServiceWarning, stacklevel=3)
        return [reference_bfs(rec.graph, s) for s in srcs]

    # ------------------------------------------------------------------
    # analytics with the finite guard
    # ------------------------------------------------------------------
    def betweenness(self, name: str, sources: Sequence[int], *,
                    tenant: str = "default") -> np.ndarray:
        """Partial Brandes betweenness with the NaN guard: a poisoned σ
        float channel (e.g. ``FaultPlan(nan_sigma=True)``) quarantines
        the session and degrades to ``betweenness_ref``."""
        rec = self._get(name, tenant)
        srcs = check_sources(sources, rec.session.n)
        if not rec.quarantined:
            bc = rec.session.betweenness_batch(srcs)
            if np.isfinite(bc).all():
                return bc
            self._quarantine(
                rec, "non-finite betweenness scores (σ channel poisoned)")
        self._event("degraded-serve", name=name, tenant=tenant,
                    n_queries=len(srcs), verb="betweenness")
        return betweenness_ref(rec.graph, srcs)

    def closeness(self, name: str, sources: Sequence[int] | None = None, *,
                  tenant: str = "default",
                  wf_improved: bool = False) -> np.ndarray:
        """Closeness centrality with the same finite guard as
        :meth:`betweenness`."""
        rec = self._get(name, tenant)
        srcs = None if sources is None else \
            check_sources(sources, rec.session.n)
        if not rec.quarantined:
            cc = rec.session.closeness_batch(srcs, wf_improved=wf_improved)
            if np.isfinite(cc).all():
                return cc
            self._quarantine(
                rec, "non-finite closeness scores (level channel poisoned)")
        self._event("degraded-serve", name=name, tenant=tenant,
                    verb="closeness")
        return closeness_ref(rec.graph, srcs, wf_improved=wf_improved)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        kinds = [e["kind"] for e in self.events]
        per_tenant: dict[str, dict[str, int]] = {}
        for r in self._sessions.values():
            t = per_tenant.setdefault(
                r.tenant, {"sessions": 0, "bytes": 0, "served": 0})
            t["sessions"] += 1
            t["bytes"] += r.cost_bytes
            t["served"] += r.served
        return {
            "sessions": len(self._sessions),
            "bytes_used": self.bytes_used(),
            "byte_budget": self.byte_budget,
            "evictions": kinds.count("evict"),
            "timeouts": kinds.count("timeout"),
            "quarantines": kinds.count("quarantine"),
            "rejections": kinds.count("admission-reject"),
            "degraded_serves": kinds.count("degraded-serve"),
            "verified": kinds.count("verify-pass"),
            "tenants": per_tenant,
        }
