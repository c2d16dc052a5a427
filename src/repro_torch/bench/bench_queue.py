"""Async-queue serving bench: RequestQueue coalescing against
call-at-a-time serving on a Poisson-arrival request stream, the port of
``benchmarks/bench_queue.py``::

    PYTHONPATH=src python -m repro_torch.bench.bench_queue --json q.json

Per graph of the suite:

* ``poisson`` — N single-source level requests with exponential
  inter-arrival gaps (mean a quarter of the measured single-query service
  time, so a backlog builds).  (a) *call-at-a-time*: one server loop sleeps
  until each arrival, then answers it through the single-source engine.
  (b) *queued*: every request is ``submit()``-ed with ``not_before`` at its
  arrival time and one ``drain(wait=True)`` coalesces the backlog into
  ``max_batch``-wide multi-source waves, refilling slots mid-flight.  Both
  makespans span first arrival to last completion; the ratio is
  call-at-a-time over queued.
* ``backlog`` — the same requests all available at t=0 (wave batching
  alone, no arrival idle time), as a secondary diagnostic.

Every queued and call-at-a-time answer is held to ``reference_bfs`` before
timing is reported.  The engines run on the card unless ``device="cpu"``;
the JSON has the reference's ``graphs`` and ``summary`` keys under the
port's envelope.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.bench.common import (bench_envelope, fmt_row, geomean,
                                      graph_suite)
from repro_torch.core.bfs import reference_bfs
from repro_torch.core.bvss import resolve_device
from repro_torch.core.policy import PrepareOptions
from repro_torch.errors import KernelFaultError
from repro_torch.serve import GraphSessionManager, RequestQueue


def serve_call_at_a_time(sess, queries, arrivals):
    """The pre-queue discipline: one server loop, sleep until each
    request's arrival, answer it alone.  Returns (makespan_s, answers)."""
    t0 = time.monotonic()
    out = []
    for q, a in zip(queries, arrivals):
        while True:
            gap = a - (time.monotonic() - t0)
            if gap <= 0:
                break
            time.sleep(min(gap, 0.0005))
        out.append(sess.levels(q))
    return time.monotonic() - t0, out


def serve_queued(queue, name, queries, arrivals):
    """Submit every request with ``not_before`` at its arrival time, then
    one draining pass coalesces the backlog into waves."""
    t0 = time.monotonic()
    futs = [queue.submit(name, q, not_before=t0 + a)
            for q, a in zip(queries, arrivals)]
    queue.drain(wait=True)
    makespan = time.monotonic() - t0
    return makespan, [f.result(0) for f in futs]


def run(scale: int = 9, n_requests: int = 12, max_batch: int = 8,
        device=None, json_path: str | None = None,
        verbose: bool = True) -> dict:
    """The ``poisson`` and ``backlog`` sections over :func:`graph_suite`;
    raises :class:`KernelFaultError` where an answer differs from the
    oracle."""
    device = resolve_device(device)
    graphs_out = {}
    for gname, g in graph_suite(scale).items():
        rng = np.random.default_rng(10)
        mgr = GraphSessionManager()
        sess = mgr.open_session(gname, g, max_batch=max_batch,
                                options=PrepareOptions(w=512, device=device))
        queue = RequestQueue(mgr)
        queries = [int(q) for q in rng.integers(0, g.n, n_requests)]
        refs = [reference_bfs(g, q) for q in queries]

        # warm both paths, then measure the single-query service time so
        # the arrival process is scaled to THIS machine (mean gap = t1/4:
        # arrivals outpace the one-at-a-time server and a backlog builds)
        sess.levels(queries[0])
        sess.levels_batch(queries[: min(2, len(queries))])
        t0 = time.monotonic()
        for q in queries[:3]:
            sess.levels(q)
        t1 = (time.monotonic() - t0) / 3
        gaps = rng.exponential(t1 / 4, n_requests)
        gaps[0] = 0.0
        arrivals = np.cumsum(gaps)

        t_call, seq = serve_call_at_a_time(sess, queries, arrivals)
        t_queued, ans = serve_queued(queue, gname, queries, arrivals)
        verified = all((a == r).all() and (s == r).all()
                       for a, s, r in zip(ans, seq, refs))
        if not verified:
            raise KernelFaultError(
                f"bench_queue/{gname}: queued levels differ from "
                f"reference_bfs")
        qs = queue.stats()
        poisson = {
            "n_requests": n_requests, "max_batch": max_batch,
            "mean_gap_sec": float(t1 / 4),
            "call_at_a_time_sec": t_call, "queued_sec": t_queued,
            "queued_vs_call_at_a_time": t_call / max(t_queued, 1e-12),
            "waves": qs["waves"], "coalesced": qs["coalesced"],
            "verified": verified,
        }

        # -- backlog: all requests available at t=0 ------------------------
        t_call0, _ = serve_call_at_a_time(sess, queries,
                                          np.zeros(n_requests))
        t_q0, ans0 = serve_queued(queue, gname, queries,
                                  np.zeros(n_requests))
        if not all((a == r).all() for a, r in zip(ans0, refs)):
            raise KernelFaultError(
                f"bench_queue/{gname}: backlog levels differ from "
                f"reference_bfs")
        backlog = {
            "call_at_a_time_sec": t_call0, "queued_sec": t_q0,
            "queued_vs_call_at_a_time": t_call0 / max(t_q0, 1e-12),
        }

        graphs_out[gname] = {
            "n": int(g.n), "m": int(g.m), "ordering": sess.ordering,
            "engine": sess.engine_name,
            "poisson": poisson, "backlog": backlog,
        }
        if verbose:
            print(fmt_row(f"bench_queue/{gname}/poisson", t_queued * 1e6,
                          f"vs_call={poisson['queued_vs_call_at_a_time']:.2f}"
                          f";coalesced={qs['coalesced']}"))
            print(fmt_row(f"bench_queue/{gname}/backlog", t_q0 * 1e6,
                          f"vs_call="
                          f"{backlog['queued_vs_call_at_a_time']:.2f}"))

    summary = {
        "geomean_queued_vs_call_at_a_time": geomean(
            [go["poisson"]["queued_vs_call_at_a_time"]
             for go in graphs_out.values()]),
        "geomean_backlog_queued_vs_call_at_a_time": geomean(
            [go["backlog"]["queued_vs_call_at_a_time"]
             for go in graphs_out.values()]),
        "total_coalesced": int(sum(go["poisson"]["coalesced"]
                                   for go in graphs_out.values())),
        "all_verified": all(go["poisson"]["verified"]
                            for go in graphs_out.values()),
    }
    out = {
        **bench_envelope("queue", scale, device),
        "note": ("poisson = RequestQueue submits with not_before at each "
                 "exponential arrival, one drain(wait=True) coalescing the "
                 "backlog into max_batch-wide waves with mid-flight slot "
                 "refills; call_at_a_time = the same arrivals answered one "
                 "at a time through the single-source engine; both "
                 "makespans span first arrival to last completion"),
        "graphs": graphs_out,
        "summary": summary,
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=False)
        if verbose:
            print(f"# wrote {json_path}")
    if verbose:
        for k, v in summary.items():
            print(f"# {k}={v if isinstance(v, (bool, int)) else f'{v:.2f}x'}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.scale, args.requests, args.max_batch, device=args.device,
        json_path=args.json)


if __name__ == "__main__":
    main()
