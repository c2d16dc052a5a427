"""``repro_torch``: the PyTorch + CUDA port of the BLEST reproduction.

A second package beside the JAX reference ``repro``, with the same layout
(``repro_torch/core/bfs.py`` ports ``repro/core/bfs.py``).  It imports
``torch``, NumPy and SciPy, never ``jax`` and nothing of ``repro``.
Entry points run on the card unless the caller asks for the CPU::

    import repro_torch

    g = repro_torch.generators.grid2d(64, 64)
    p = repro_torch.prepare(g)                     # on the CUDA device
    levels = p.levels(0)                           # NumPy int32 (n,)

    p_cpu = repro_torch.prepare(g, device="cpu")   # the PyTorch twins

    sess = repro_torch.GraphSession(g, max_batch=8)  # wave serving
    lvs = sess.levels_batch([0, 5, 9])             # one array per query
    bc = sess.betweenness_batch([0, 5])            # float64 (n,)
    pr = sess.pagerank()                           # float64 (n,), sums to 1

    mgr = repro_torch.GraphSessionManager(verify_fraction=1.0)
    mgr.open_session("g", g, tenant="acme", max_batch=8)
    mgr.levels_batch("g", [0, 5], tenant="acme", deadline_s=0.5)
    q = repro_torch.RequestQueue(mgr)              # async, coalescing
    fut = q.submit("g", 9, tenant="acme"); q.drain(); fut.result()
    mgr.update_edges("g", inserts=[(0, 9)], tenant="acme")  # next epoch

    p2 = repro_torch.apply_edge_updates(p, inserts=[(0, 9)])  # epoch 1
    p3 = repro_torch.prepare(g, autotune=True)     # tuned ladder and cap

Ported so far: single-source BLEST (``prepare(g).levels(src)``) with
hand-written CUDA kernels for ``bvss_pull``, ``bvss_push`` and
``finalize_pack_sweep``, and wave serving (``GraphSession.levels_batch``,
the components, eccentricity and closeness verbs) with a hand-written
CUDA ``bvss_spmm`` (its marks form ``bvss_spmm_mark`` on the main path),
and the float-channel verbs (betweenness, SSSP,
PageRank and ``weights=``) with hand-written CUDA ``bvss_spmm_w``,
``bvss_spmm_t`` and ``bvss_spmm_minplus``, and the paper's Table-2
comparison (the BRS, dense-pull and CSR push/pull/dirop baselines,
``python -m repro_torch.launch.bfs``, the bench scripts in
``repro_torch.bench``) with hand-written CUDA ``bit_spmm`` (the dense
multi-source baseline) and ``finalize_sweep`` (the kernel bench), and
the analytics launcher (``python -m repro_torch.launch.analytics``) with
the paper's Tables 1a, 1b and 4, Figure 3, the RMAT scale sweep and the
analytics bench in ``repro_torch.bench``, and the hardened serving tier
(``GraphSessionManager``, ``RequestQueue``, the ``FaultPlan`` seams on
the hand-written kernels, the launcher's ``--service`` and ``--queue``),
and autotuning (``prepare(g, autotune=True)``, which times the
hand-written ``bvss_pull`` and ``bvss_push``) and streaming edge updates
(``apply_edge_updates``, ``GraphSession.update_edges``,
``GraphSessionManager.update_edges``; the patched, rebuilt and
reprepared paths) with the reference's hybrid bench
(``repro_torch.bench.bench_hybrid``), and the mesh-native single-source
BFS on ``torch.distributed`` (``prepare(g, mesh=...)`` over a 1-D or 2-D
``DeviceMesh`` from ``repro_torch.distributed``, one process per rank;
the launcher's ``--devices``).  The package exports every name of the
reference's façade (``tests/api_surface.txt``).
"""
from repro_torch.core.bfs import reference_bfs
from repro_torch.core.bvss_delta import UpdateReport, apply_edge_updates
from repro_torch.core.policy import (PreparedBFS, PrepareOptions,
                                     build_problem, parents_from_levels,
                                     prepare)
from repro_torch.errors import (AdmissionError, BlestError, ConfigError,
                                DeadlineExceeded, GraphValidationError,
                                KernelBuildError, KernelFaultError,
                                QueueFullError, StaleEpochError)
from repro_torch.graphs import Graph, from_edges, generators, src_of_edges
from repro_torch.serve import (NO_FAULTS, DegradedServiceWarning, FaultPlan,
                               GraphSession, GraphSessionManager,
                               RequestQueue, TenantQuota, TimeoutResult,
                               WaveFuture, WaveScheduler, session_cost_bytes)

__version__ = "0.5.0"

#: every query verb a session serves (``GraphSession.VERBS``)
VERBS = GraphSession.VERBS

__all__ = [
    "GraphSession", "GraphSessionManager", "TenantQuota", "TimeoutResult",
    "DegradedServiceWarning", "session_cost_bytes", "RequestQueue",
    "WaveFuture", "WaveScheduler", "FaultPlan", "NO_FAULTS", "prepare",
    "PrepareOptions", "PreparedBFS", "build_problem", "UpdateReport",
    "apply_edge_updates", "parents_from_levels", "reference_bfs", "Graph",
    "from_edges", "src_of_edges", "generators", "VERBS", "__version__",
    "BlestError", "GraphValidationError", "ConfigError", "AdmissionError",
    "QueueFullError", "DeadlineExceeded", "StaleEpochError",
    "KernelFaultError", "KernelBuildError",
]
