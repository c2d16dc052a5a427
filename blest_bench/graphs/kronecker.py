"""Graph 500 Kronecker generator (the spec's reference ``kronecker_generator``).

A frozen NumPy transcription of the Graph 500 Benchmark 1 reference code
(graph500.org, ``kronecker_generator.m``): ``edgefactor * 2**scale`` edge
tuples, each placed by ``scale`` independent draws of the 2x2 initiator
``[[A, B], [C, D]]``.  The spec's last steps, the random relabelling of the
vertices and the shuffle of the tuples, are left to the caller: the harness
relabels from the run's seed, and the tuple order does not matter to a
simple undirected graph.
"""
from __future__ import annotations

import numpy as np

#: the size that the harness's CPU tests give every configuration of this
#: family, merged over its parameters (``tiny.make_root``)
TINY = {"scale": 7}


def edge_tuples(params: dict, rng: np.random.Generator
                ) -> tuple[int, np.ndarray, np.ndarray]:
    """``(n, start, end)``: the raw tuples, self-loops and repeats included."""
    scale = int(params["scale"])
    n = 1 << scale
    m = int(params["edgefactor"]) * n
    a, b, c = float(params["A"]), float(params["B"]), float(params["C"])
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = np.zeros(m, dtype=np.int64)
    jj = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > np.where(ii_bit, c_norm, a_norm)
        ii |= ii_bit.astype(np.int64) << bit
        jj |= jj_bit.astype(np.int64) << bit
    return n, ii, jj
