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

Ported so far: single-source BLEST (``prepare(g).levels(src)``) with
hand-written CUDA kernels for ``bvss_pull``, ``bvss_push`` and
``finalize_pack_sweep``, and wave serving (``GraphSession.levels_batch``,
the components, eccentricity and closeness verbs) with a hand-written
CUDA ``bvss_spmm``, and the float-channel verbs (betweenness, SSSP,
PageRank and ``weights=``) with hand-written CUDA ``bvss_spmm_w``,
``bvss_spmm_t`` and ``bvss_spmm_minplus``, and the paper's Table-2
comparison (the BRS, dense-pull and CSR push/pull/dirop baselines,
``python -m repro_torch.launch.bfs``, the bench scripts in
``repro_torch.bench``) with hand-written CUDA ``bit_spmm`` (the dense
multi-source baseline) and ``finalize_sweep`` (the kernel bench), and
the analytics launcher (``python -m repro_torch.launch.analytics``) with
the paper's Tables 1a, 1b and 4, Figure 3, the RMAT scale sweep and the
analytics bench in ``repro_torch.bench``.
"""
from repro_torch.core.bfs import reference_bfs
from repro_torch.core.policy import (PreparedBFS, PrepareOptions,
                                     parents_from_levels, prepare)
from repro_torch.errors import (AdmissionError, BlestError, ConfigError,
                                DeadlineExceeded, GraphValidationError,
                                KernelBuildError, KernelFaultError,
                                QueueFullError, StaleEpochError)
from repro_torch.graphs import Graph, from_edges, generators
from repro_torch.serve import GraphSession

__all__ = [
    "GraphSession", "prepare", "PrepareOptions", "PreparedBFS",
    "parents_from_levels", "reference_bfs", "Graph", "from_edges",
    "generators",
    "BlestError", "GraphValidationError", "ConfigError", "AdmissionError",
    "QueueFullError", "DeadlineExceeded", "StaleEpochError",
    "KernelFaultError", "KernelBuildError",
]
