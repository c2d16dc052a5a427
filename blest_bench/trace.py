"""Profiler arithmetic: what a ``torch.profiler`` trace of a traced slice says.

Busy time is the union of the device's kernel and copy intervals inside
the slice (the arithmetic of ``chip_smoke.device_spans``); idle gaps are
the rest of the slice, each named by what the host thread that opened the
slice was doing at the gap's middle (its innermost profiled call, or
``python`` where no call was open).  The port's hand-written kernels are
told apart by name.

The gaps are also handed back, so that a run with the port's spans on can
put each on the span clock (:func:`on_span_clock`) and name it by the
program spans open at its middle (:func:`idle_under`).
"""
from __future__ import annotations

import re
from typing import Sequence

import numpy as np

#: the port's hand-written CUDA kernels (``repro_torch/kernels/csrc``), as
#: the profiler names them
HAND_KERNEL = re.compile(
    r"\(anonymous namespace\)::(bit_spmm_kernel|bvss_pull_kernel|"
    r"bvss_push_kernel|bvss_push_level_kernel|bvss_spmm_minplus_kernel|"
    r"bvss_spmm_quads|bvss_spmm_scalar|bvss_spmm_t_kernel|bvss_spmm_w_quads|"
    r"bvss_spmm_w_rows|bvss_spmm_w_scalar|finalize_pack_kernel|"
    r"finalize_sweep_kernel)\b(<[^>]*>)?")

TOP = 10


def span_totals(spans: Sequence) -> dict[str, dict]:
    """For each name of the port's spans (``repro_torch.tracing.Span``), how
    many there are (``n``) and their seconds (``s``)."""
    out: dict[str, dict] = {}
    for s in spans:
        tot = out.setdefault(s.name, {"n": 0, "s": 0.0})
        tot["n"] += 1
        tot["s"] += (s.end_ns - s.start_ns) / 1e9
    return out


def on_span_clock(gaps_us: Sequence[tuple[float, float]],
                  slice_us: tuple[float, float], slice_ns: tuple[int, int]
                  ) -> list[tuple[float, float]]:
    """Profiler times (µs) on the span clock (ns), by the slice's start and
    end as each clock read them."""
    (u0, u1), (p0, p1) = slice_us, slice_ns
    rate = (p1 - p0) / (u1 - u0) if u1 > u0 else 1e3
    return [(p0 + (a - u0) * rate, p0 + (b - u0) * rate) for a, b in gaps_us]


def union_s(spans: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals sorted by start."""
    total, end = 0.0, float("-inf")
    for a, b in spans:
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def hand_kernel_name(name: str) -> str | None:
    match = HAND_KERNEL.search(name)
    return None if match is None else match.group(1) + (match.group(2) or "")


def _merged(spans: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_labels(cpu: list[tuple[float, float, object]], points,
                 none: object = "python") -> list:
    """The label of the innermost call open at each of the sorted ``points``
    (``none`` where no call is); the calls of one thread nest, so one sweep
    with a stack finds them all."""
    cpu = sorted(cpu, key=lambda e: (e[0], -e[1]))
    labels, stack, i = [], [], 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        labels.append(stack[-1][2] if stack else none)
    return labels


def idle_under(gaps_ns: Sequence[tuple[float, float]], spans: Sequence
               ) -> dict[str, float]:
    """Seconds of the sorted idle gaps (span clock) by the port's spans open
    at each gap's middle: the path of their names, outermost first, joined
    by ``/`` (``""`` where none is open).  ``spans`` are one thread's."""
    by_id = {s.id: s for s in spans}
    mids = [(a + b) / 2 for a, b in gaps_ns]
    ids = _host_labels([(s.start_ns, s.end_ns, s.id) for s in spans], mids,
                       none=None)
    out: dict[str, float] = {}
    for (a, b), sid in zip(gaps_ns, ids):
        names = []
        while sid is not None and sid in by_id:
            names.append(by_id[sid].name)
            sid = by_id[sid].parent
        path = "/".join(reversed(names))
        out[path] = out.get(path, 0.0) + (b - a) / 1e9
    return out


def summarize(prof, span_name: str) -> dict:
    """Busy, idle and hand-kernel time of the slice that the host marked
    with ``record_function(span_name)``, in seconds, and the breakdown."""
    from torch.autograd import DeviceType
    events = prof.events()
    span = next(e for e in events if e.name == span_name
                and e.device_type == DeviceType.CPU)
    t0, t1 = span.time_range.start, span.time_range.end
    device = sorted(
        (max(e.time_range.start, t0), min(e.time_range.end, t1), e.name)
        for e in events if e.device_type == DeviceType.CUDA
        and e.name != span_name          # the span's own mark on the device
        and e.time_range.end > t0 and e.time_range.start < t1)
    spans = [(a, b) for a, b, _ in device]
    hand_spans, hand_time = [], {}
    for a, b, name in device:
        short = hand_kernel_name(name)
        if short is not None:
            hand_spans.append((a, b))
            hand_time[short] = hand_time.get(short, 0.0) + (b - a)
    busy = _merged(spans)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CPU and e.thread == span.thread
           and e.name != span_name]
    mids = np.array([(a + b) / 2 for a, b in gaps])
    idle: dict[str, float] = {}
    for (a, b), label in zip(gaps, _host_labels(cpu, mids)):
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    ops = {e.key: e.self_device_time_total / 1e6
           for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key != span_name
           and e.self_device_time_total > 0}
    ops.update({k: v / 1e6 for k, v in hand_time.items()})
    return {
        "slice_us": (t0, t1),
        "gaps_us": gaps,
        "window_s": (t1 - t0) / 1e6,
        "busy_s": union_s(spans) / 1e6,
        "hand_busy_s": union_s(hand_spans) / 1e6,
        "hand_events": len(hand_spans),
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }
