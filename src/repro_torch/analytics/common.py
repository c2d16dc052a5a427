"""Shared helpers for the analytics wave clients."""
from __future__ import annotations

import numpy as np
import torch


def pad_cohort(chunk: np.ndarray, width: int) -> np.ndarray:
    """Pad a tail cohort to the fixed wave width by repeating its last
    source (callers drop the padded columns' results).  Repetition — not
    e.g. vertex 0 — keeps padded columns converging no later than the
    real ones."""
    if len(chunk) >= width:
        return chunk
    return np.concatenate([chunk, np.repeat(chunk[-1:], width - len(chunk))])


def host_levels(levels: "torch.Tensor | np.ndarray") -> np.ndarray:
    """A level array from an engine (a tensor on any device) on the host."""
    if isinstance(levels, torch.Tensor):
        return levels.cpu().numpy()
    return np.asarray(levels)
