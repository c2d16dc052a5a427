"""Typed error hierarchy of the BLEST stack (DESIGN §2.7), copied from
``repro/errors.py`` so that the PyTorch port never imports the JAX package.

Every ingress path — graph construction (``graphs/csr.py``), preparation
(``core/policy.prepare``), the serving verbs (``repro.serve``) and the
launchers — raises these instead of bare ``assert``s, so validation
survives ``python -O`` (a bare ``assert`` is compiled away under ``-O``;
a load-bearing one is a latent silent-wrong-answer bug).  The CI ``chaos``
workflow runs an ``-O`` smoke lane to prove the property holds.

Hierarchy::

    BlestError
    ├── GraphValidationError   malformed graph / out-of-range source ids
    ├── ConfigError            unusable engine/tuning configuration
    ├── AdmissionError         multi-tenant quota or memory budget refusal
    │   └── QueueFullError     async request queue refused a submission
    ├── DeadlineExceeded       a query outlived its per-request budget
    ├── StaleEpochError        edge updates raced a newer prepared epoch
    ├── KernelFaultError       device result failed an oracle cross-check
    └── KernelBuildError       a CUDA kernel failed to build, load or launch

``DeadlineExceeded`` is only *raised* when a caller demands a complete
answer; the serving tier normally degrades to a partial
``serve.TimeoutResult`` instead (bounded latency, not a hang).
``KernelFaultError`` is what the verify-mode sampling policy
(``serve.session_manager``) raises internally when a wave result diverges
from the ``kernels/ref.py`` oracle — the session is quarantined and the
query re-served on the reference path, so callers see a degraded-but-
correct answer plus a structured warning, never the wrong levels.
"""
from __future__ import annotations

import numpy as np


class BlestError(Exception):
    """Base class of every typed error the BLEST stack raises."""


class GraphValidationError(BlestError, ValueError):
    """A graph, permutation or source id failed ingress validation."""


class ConfigError(BlestError, ValueError):
    """An engine or tuning configuration is unusable (e.g. a bucket count
    the queue-width ladder cannot honour).  Raised instead of silently
    degrading to a nearby valid configuration — a silent fallback would
    make autotuner search results lie about what actually ran."""


class AdmissionError(BlestError):
    """A request was refused at admission (quota / byte budget / slot
    pool exhausted).  Carries a machine-readable ``reason`` code."""

    def __init__(self, message: str, *, reason: str = "rejected"):
        super().__init__(message)
        self.reason = reason


class QueueFullError(AdmissionError):
    """The async request queue refused a submission (DESIGN §2.10).

    A bounded queue rejects at ingress instead of buffering an unbounded
    backlog — the same fail-fast contract as :class:`AdmissionError`,
    which this specialises so queue callers can catch it separately.
    ``reason`` is ``"capacity"`` (global queue depth) or
    ``"tenant-backlog"`` (one tenant's pending share)."""


class DeadlineExceeded(BlestError, TimeoutError):
    """A query exceeded its per-request deadline."""


class StaleEpochError(BlestError):
    """An edge-update batch was applied against a superseded epoch.

    :func:`repro.core.bvss_delta.apply_edge_updates` is a functional
    compare-and-swap: callers that captured ``prepared.epoch`` before
    computing a delta pass it as ``expected_epoch``, and a concurrent
    update that bumped the epoch in between raises this instead of
    silently merging onto the wrong base.  Carries the ``expected`` and
    ``actual`` epochs."""

    def __init__(self, message: str, *, expected: int, actual: int):
        super().__init__(message)
        self.expected = expected
        self.actual = actual


class KernelFaultError(BlestError):
    """A device kernel result failed verification against its oracle."""


class KernelBuildError(BlestError, RuntimeError):
    """A hand-written CUDA kernel could not be compiled, loaded or launched.

    Raised instead of answering with the kernel's plain PyTorch twin: a
    CUDA tensor either goes through its kernel or the call fails."""


def check_source(src: int, n: int, *, what: str = "source") -> int:
    """Validate one vertex id against ``[0, n)`` and return it as int.

    Rejects bool (a silent 0/1 coercion), non-integral values, and ids
    outside the vertex range — including NEGATIVE ids, which NumPy fancy
    indexing would otherwise silently wrap (``perm[-1]`` is the last
    vertex, not an error: the exact silent-wrong-answer bug this guards).
    """
    if isinstance(src, (bool, np.bool_)) or \
            not isinstance(src, (int, np.integer)):
        raise GraphValidationError(
            f"{what} must be an integer vertex id, got "
            f"{type(src).__name__} {src!r}")
    s = int(src)
    if not 0 <= s < n:
        raise GraphValidationError(
            f"{what} {s} out of range for a graph with {n} vertices "
            f"(valid ids are 0..{n - 1})")
    return s


def check_sources(sources, n: int, *, what: str = "sources") -> list[int]:
    """Validate a sequence of vertex ids (see :func:`check_source`).

    Arrays are validated vectorised; generic sequences element-by-element
    (so a stray bool / float / string in a Python list is caught before
    ``np.asarray`` silently coerces it)."""
    if isinstance(sources, np.ndarray):
        arr = sources
        if arr.ndim != 1:
            raise GraphValidationError(
                f"{what} must be a 1-D sequence of vertex ids, got shape "
                f"{arr.shape}")
        if arr.size == 0:
            return []
        if arr.dtype == np.bool_ or \
                not np.issubdtype(arr.dtype, np.integer):
            raise GraphValidationError(
                f"{what} must be integer vertex ids, got dtype {arr.dtype}")
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= n):
            bad = arr[(arr < 0) | (arr >= n)]
            raise GraphValidationError(
                f"{what} contain out-of-range ids {bad[:8].tolist()} for a "
                f"graph with {n} vertices (valid ids are 0..{n - 1})")
        return [int(s) for s in arr]
    try:
        items = list(sources)
    except TypeError as e:
        raise GraphValidationError(
            f"{what} must be a sequence of vertex ids, got "
            f"{type(sources).__name__}") from e
    return [check_source(s, n, what=f"{what}[{i}]")
            for i, s in enumerate(items)]


def check_weights(weights, m: int, *, what: str = "weights") -> np.ndarray:
    """Validate a per-edge weight vector for the weighted verbs (SSSP /
    weighted PageRank) and return it as float32 (m,).

    Rejects a shape that does not match the edge count, non-numeric or
    bool dtypes, NaN / ±inf entries, and NON-POSITIVE weights — zero is
    rejected along with negatives because delta-stepping's bucket
    invariant (and termination of the label-correcting inner loop on
    cycles) requires strictly positive edge lengths.
    """
    try:
        arr = np.asarray(weights)
    except Exception as e:  # ragged lists etc.
        raise GraphValidationError(
            f"{what} must be a numeric array of per-edge weights, got "
            f"{type(weights).__name__}") from e
    if arr.dtype == np.bool_ or arr.dtype == object or \
            not np.issubdtype(arr.dtype, np.number):
        raise GraphValidationError(
            f"{what} must have a real numeric dtype, got {arr.dtype}")
    if arr.shape != (m,):
        raise GraphValidationError(
            f"{what} must have shape ({m},) — one weight per CSR edge — "
            f"got shape {arr.shape}")
    arr = arr.astype(np.float32)
    if arr.size:
        if np.isnan(arr).any():
            raise GraphValidationError(
                f"{what} contain NaN at edges "
                f"{np.flatnonzero(np.isnan(arr))[:8].tolist()}")
        if np.isinf(arr).any():
            raise GraphValidationError(
                f"{what} contain non-finite entries at edges "
                f"{np.flatnonzero(np.isinf(arr))[:8].tolist()} (+inf is "
                f"reserved for the no-edge sentinel in the weight plane)")
        if (arr <= 0).any():
            bad = np.flatnonzero(arr <= 0)
            raise GraphValidationError(
                f"{what} must be strictly positive (delta-stepping bucket "
                f"invariant); edges {bad[:8].tolist()} have values "
                f"{arr[bad[:8]].tolist()}")
    return arr
