"""Serving tier of the PyTorch port: :class:`GraphSession` (wave serving
and the analytics verbs that are wave clients), the hardened multi-tenant
:class:`GraphSessionManager` (quotas, the byte-budgeted LRU, deadlines,
verify-mode sampling and quarantine), the async :class:`RequestQueue`, and
the :class:`FaultPlan` seams around the hand-written kernels; and, outside
the graph façade as in the reference, the LM tier's continuous-batching
:class:`ServeEngine` with its :class:`Request` and :class:`Completion`."""
from repro_torch.serve.engine import Completion, Request, ServeEngine
from repro_torch.serve.faults import NO_FAULTS, FaultPlan
from repro_torch.serve.graph_session import GraphSession
from repro_torch.serve.queue import RequestQueue, WaveFuture, WaveScheduler
from repro_torch.serve.session_manager import (DegradedServiceWarning,
                                               GraphSessionManager,
                                               TenantQuota, TimeoutResult,
                                               session_cost_bytes)

__all__ = ["Completion", "Request", "ServeEngine", "GraphSession",
           "FaultPlan", "NO_FAULTS", "GraphSessionManager", "TenantQuota", "TimeoutResult", "DegradedServiceWarning",
           "session_cost_bytes", "RequestQueue", "WaveFuture",
           "WaveScheduler"]
