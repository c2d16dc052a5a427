"""The port's span recorder: where the host's time goes, layer by layer.

A span marks one block of work at a layer boundary::

    from repro_torch.tracing import span

    with span("wave.level"):
        state, live = eng.level_step(state)

Recording is off by default and is turned on only by :func:`enable`.  Off,
``span`` checks one module flag and returns the same shared no-op object:
it allocates nothing and reads no clock.  On, each span records its name,
its id, its parent's id (the innermost span open on the same thread), a
request id (its parent's unless given), the thread, and its start and end
in ``time.perf_counter_ns()``.  Spans stay in memory until :func:`drain`
hands them over; nothing is written anywhere.

:func:`enable` also takes one anchor pair ``(perf_counter_ns, time_ns)``,
so times on the Unix clock (a ``torch.profiler`` event's start is the
trace's ``kineto_results.trace_start_ns()`` plus its ``time_range`` in
µs) convert to the span clock with :func:`from_unix_ns`.  :func:`self_ns`
and :func:`innermost` are the arithmetic a reader of the spans needs: a
span's self time, and which span the host was in at given instants.

The span sites, one per layer boundary of batched level serving:
``session.prepare`` / ``session.bind`` (``GraphSession.__init__``);
``prepare.order``, ``prepare.permute``, ``prepare.bvss``,
``prepare.device`` and ``prepare.autotune`` (``core/policy.prepare``);
``kernels.build`` and ``kernels.load`` (``kernels/_build``);
``wave.batch`` (``GraphSession.levels_batch``, one request id a batch);
``wave.refill``, ``wave.level``, ``wave.harvest`` and ``wave.deliver``
(``core/multi_source.drive_wave``); ``wave.step``, ``wave.finalize`` and
``wave.copy_wait`` (``make_ms_engine``: one ``wave.copy_wait`` around each
blocking device-to-host copy that an engine counts in ``host_syncs``).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Sequence


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None     # id of the enclosing span on the same thread
    request: int | None    # shared by the spans of one request
    thread: int            # threading.get_ident() of the recording thread
    start_ns: int          # time.perf_counter_ns()
    end_ns: int


_on = False
_spans: list[Span] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_anchor: tuple[int, int] | None = None


class _Off:
    """The shared span of disabled tracing: enters and exits, records
    nothing.  Its methods are static, so the ``with`` statement's lookup
    binds no method object: entering and leaving allocate nothing."""

    __slots__ = ()
    __enter__ = staticmethod(lambda: None)
    __exit__ = staticmethod(lambda exc_type, exc, tb: None)


_OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "request", "start")

    def __init__(self, name: str, request: int | None):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        if self.request is None and outer is not None:
            self.request = outer.request
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        rec = Span(self.name, self.id, self.parent, self.request,
                   threading.get_ident(), self.start, end)
        with _lock:
            _spans.append(rec)
        return False


def span(name: str, request: int | None = None):
    """A context manager that records one span while tracing is on (module
    docstring); ``request`` sets the request id, which spans opened inside
    it inherit."""
    if not _on:
        return _OFF
    return _Open(name, request)


def enable() -> None:
    """Start recording, and take the clock anchor (module docstring)."""
    global _on, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable() -> None:
    """Stop recording; spans open now are still recorded when they close."""
    global _on
    _on = False


def drain() -> list[Span]:
    """The spans recorded so far, in the order they closed; clears them."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def from_unix_ns(t_ns: float) -> float:
    """A time on the Unix clock (ns) on the span clock, by the anchor."""
    if _anchor is None:
        raise RuntimeError("tracing was never enabled: no clock anchor")
    return t_ns - _anchor[1] + _anchor[0]


def self_ns(spans: Sequence[Span]) -> dict[int, int]:
    """Each span's duration minus the time its child spans cover (the
    children of a span run on its thread, one after another)."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def innermost(spans: Sequence[Span], points: Sequence[float]
              ) -> list[Span | None]:
    """The innermost of ``spans`` open at each of the sorted ``points``
    (span clock, ns), or None where none is.  Pass the spans of one thread:
    those nest, so one sweep with a stack finds them all."""
    order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    found: list[Span | None] = []
    stack: list[Span] = []
    i = 0
    for p in points:
        while i < len(order) and order[i].start_ns <= p:
            while stack and stack[-1].end_ns <= order[i].start_ns:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end_ns < p:
            stack.pop()
        found.append(stack[-1] if stack else None)
    return found
