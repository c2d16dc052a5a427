"""GPipe pipeline parallelism over a mesh axis, the port of
``repro/distributed/pipeline.py``.

The multi-pod mesh's "pod" axis can carry the pipeline: stage ``s`` (the
rank at position ``s`` of the axis) holds its own stage's parameters,
and micro-batch activations pass from stage to stage, one ring step a
tick (:func:`~repro_torch.distributed.collectives.ring_shift`, the
reference's ``ppermute``).  The bubble fraction is the standard
(S - 1) / (M + S - 1).  SPMD: every rank of the mesh calls the returned
function with its own stage's parameters and the same full batch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import axis_size, ring_shift


def make_gpipe(mesh, stage_fn, n_micro: int, axis: str = "pod"):
    """``stage_fn(stage_params, x) -> y`` with ``y.shape == x.shape``.

    Returns ``f(stage_params, x)``: ``stage_params`` this rank's stage's,
    ``x`` the full batch (cut into ``n_micro`` micro-batches inside).
    Over ``T = M + S - 1`` ticks, stage 0 feeds micro-batch ``min(t, M -
    1)``, every other stage the activation its predecessor passed it, and
    the last stage banks micro-batch ``t - (S - 1)`` once ``t >= S - 1``;
    a SUM all-reduce of the outputs, zero but on the last stage, gives
    every rank the result.  It equals applying the stages in order."""
    S = axis_size(mesh, axis)

    def run(stage_params, x):
        s = mesh.get_local_rank(axis)
        M = n_micro
        micro = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        outputs = torch.zeros_like(micro)
        cur = torch.zeros_like(micro[0])
        for t in range(M + S - 1):
            inp = micro[min(t, M - 1)] if s == 0 else cur
            y = stage_fn(stage_params, inp)
            if s == S - 1 and t >= S - 1:
                outputs[t - (S - 1)] = y
            cur = ring_shift(y, mesh, axis)
        if S > 1:
            dist.all_reduce(outputs, op=dist.ReduceOp.SUM,
                            group=mesh.get_group(axis))
        return outputs.reshape(x.shape)

    return run


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
