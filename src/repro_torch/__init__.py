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

This slice ports single-source BLEST (``prepare(g).levels(src)``) with
hand-written CUDA kernels for ``bvss_pull``, ``bvss_push`` and
``finalize_pack_sweep``.
"""
from repro_torch.core.bfs import reference_bfs
from repro_torch.core.policy import (PreparedBFS, PrepareOptions,
                                     parents_from_levels, prepare)
from repro_torch.errors import (AdmissionError, BlestError, ConfigError,
                                DeadlineExceeded, GraphValidationError,
                                KernelBuildError, KernelFaultError,
                                QueueFullError, StaleEpochError)
from repro_torch.graphs import Graph, from_edges, generators

__all__ = [
    "prepare", "PrepareOptions", "PreparedBFS", "parents_from_levels",
    "reference_bfs", "Graph", "from_edges", "generators",
    "BlestError", "GraphValidationError", "ConfigError", "AdmissionError",
    "QueueFullError", "DeadlineExceeded", "StaleEpochError",
    "KernelFaultError", "KernelBuildError",
]
