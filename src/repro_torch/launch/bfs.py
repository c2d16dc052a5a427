"""BFS workload launcher — the paper's own pipeline, end to end, on the
card (the port of ``repro/launch/bfs.py``)::

    PYTHONPATH=src python -m repro_torch.launch.bfs --graph rmat --scale 12 \
        --engine blest_full --sources 8
    PYTHONPATH=src python -m repro_torch.launch.bfs --graph road --scale 10 \
        --engine brs --device cpu

Pipeline per the paper: classify the graph (social-like?), pick the
ordering (JaccardWithWindows+shingle vs RCM), build the BVSS, run the BFS
engine of the chosen Table-2 variant, verify against the host oracle.  All
preparation goes through :func:`repro_torch.core.policy.prepare`.

``--service`` instead serves the queries through the hardened
:class:`~repro_torch.serve.GraphSessionManager` (batched multi-source
waves over the slot pool of ``--max-batch`` columns, ``--deadline-s``,
``--verify-fraction``), or with ``--queue`` through the async
:class:`~repro_torch.serve.RequestQueue`, and reports wave against
sequential timing::

    PYTHONPATH=src python -m repro_torch.launch.bfs --graph road --scale 10 \
        --engine blest_full --sources 8 --service --queue \
        --verify-fraction 1.0 --device cpu

``--devices N`` runs the whole pipeline mesh-native (DESIGN §2.4): the
launcher spawns N ranks (one process each, a TCP store on 127.0.0.1, NCCL
on the card and gloo under ``--device cpu``), every rank calls
``prepare(g, mesh=...)`` on a 1-D mesh of N ranks and runs the same
sources, and rank 0 prints a ``[bfs] sharded: ...`` line and the verdict::

    PYTHONPATH=src python -m repro_torch.launch.bfs --graph road --scale 10 \
        --engine blest_ac --sources 3 --devices 4 --device cpu

``--service`` (and ``--queue``) with ``--devices N`` serves through a
session on that mesh in every rank, each rank making the same calls.
``--devices 1`` is a mesh of one rank (the reference treats it as no
mesh); without ``--devices`` the engines run on one device, no process
group.  On the card N may not exceed the cards there are: that raises
:class:`~repro_torch.errors.ConfigError` before any process starts.

The engines run on the CUDA card unless ``--device cpu`` asks for the CPU
(the kernels' PyTorch twins).
"""
from __future__ import annotations

import argparse
import socket
import time

import numpy as np
import torch

from repro_torch import (GraphSessionManager, PrepareOptions, RequestQueue,
                         TimeoutResult, prepare)
from repro_torch.core import reference_bfs
from repro_torch.core.policy import BVSS_ENGINES
from repro_torch.distributed import bfs_mesh
from repro_torch.core.ordering import social_like_report
from repro_torch.errors import ConfigError, KernelFaultError
from repro_torch.graphs import generators as gen


def build_graph(name: str, scale: int, seed: int = 0):
    if name == "rmat":
        return gen.rmat(scale, 16, seed=seed)
    if name == "urand":
        return gen.erdos_renyi(1 << scale, 16.0, seed=seed)
    if name == "road":
        side = int((1 << scale) ** 0.5)
        return gen.grid2d(side, side, shuffle=True, seed=seed)
    if name == "clustered":
        return gen.clustered((1 << scale) // 64, 64, seed=seed)
    raise ValueError(name)


ENGINE_VARIANTS = {
    # paper Table-2 variants; "full" picks lazy-vs-eager by the update-
    # divergence threshold (paper §5 static policy, core/policy.py);
    # engine=None means "let the policy choose"
    "blest_a": dict(engine="blest", order=False),
    "blest_ab": dict(engine="blest", order=True),
    "blest_ac": dict(engine="blest_lazy", order=False),
    "blest_full": dict(engine=None, order=True),
    "brs": dict(engine="brs", order=False),
    "csr_push": dict(engine="csr_push", order=False),
    "csr_pull": dict(engine="csr_pull", order=False),
    "dirop": dict(engine="dirop", order=False),
}

def run_service(g, args, *, mesh=None, verbose: bool = True) -> None:
    """--service: hardened wave-batched serving through the multi-tenant
    GraphSessionManager (admission, deadlines, verify-mode sampling), on
    ``mesh`` when given (every rank runs this; ``verbose`` ranks print)."""
    def say(line: str) -> None:
        if verbose:
            print(line, flush=True)

    variant = ENGINE_VARIANTS[args.engine]
    mgr = GraphSessionManager(verify_fraction=args.verify_fraction)
    sess = mgr.open_session(
        "cli", g, max_batch=args.max_batch,
        options=PrepareOptions(w=512, seed=args.seed,
                               order=variant["order"],
                               engine=variant["engine"], device=args.device,
                               mesh=mesh))
    say(f"[bfs] session up: ordering={sess.ordering} "
          f"engine={sess.engine_name} "
          f"compression={sess.bvss.compression_ratio():.3f} "
          f"preprocess={sess.preprocess_s:.2f}s "
          f"cost={mgr.bytes_used() / 1e6:.1f}MB "
          f"verify_fraction={args.verify_fraction}")
    rng = np.random.default_rng(args.seed)
    queries = [int(q) for q in rng.integers(0, g.n, args.sources)]
    sess.levels(queries[0])                      # warm both paths
    sess.levels_batch(queries[: min(2, len(queries))])
    if args.queue:
        # async path (DESIGN §2.10): non-blocking submits coalesce into
        # shared waves; futures resolve as each column converges
        q = RequestQueue(mgr)
        t0 = time.time()
        futs = [q.submit("cli", s, deadline_s=args.deadline_s)
                for s in queries]
        q.drain()
        lvs = [f.result(0) for f in futs]
        t_wave = time.time() - t0
        qs = q.stats()
        say(f"[bfs] queue: {qs['completed']} completed over "
              f"{qs['waves']} waves, {qs['coalesced']} coalesced "
              f"mid-flight, {qs['timeouts']} deadline harvests")
    else:
        t0 = time.time()
        lvs = mgr.levels_batch("cli", queries, deadline_s=args.deadline_s)
        t_wave = time.time() - t0
    t0 = time.time()
    seq = [sess.levels(q) for q in queries]
    t_seq = time.time() - t0
    n_partial = sum(isinstance(lv, TimeoutResult) for lv in lvs)
    if args.verify:
        for q, lv, lv_seq in zip(queries, lvs, seq):
            ref = reference_bfs(g, q)
            if isinstance(lv, TimeoutResult):
                continue             # partial by deadline, not comparable
            if not (lv == ref).all():
                raise KernelFaultError(f"wave mismatch from source {q}")
            if not (lv_seq == ref).all():
                raise KernelFaultError(f"seq mismatch from source {q}")
    st = mgr.stats()
    say(f"[bfs] service: {len(queries)} queries, "
          f"wave={t_wave * 1e3:.1f}ms "
          f"sequential={t_seq * 1e3:.1f}ms "
          f"speedup={t_seq / max(t_wave, 1e-9):.2f}x "
          f"(max_batch={args.max_batch}, partial={n_partial}, "
          f"verified={st['verified']}, quarantines={st['quarantines']})"
          + ("; VERIFIED vs oracle" if args.verify else ""))


def _free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_mesh(args, threads: int, run=None) -> None:
    """--devices N: call ``run(g, args, mesh, verbose)`` in each of N
    spawned ranks on a 1-D mesh over them (``args.graph``, ``.scale``,
    ``.seed`` and ``.device`` say what and where), rank 0 verbose; by
    default :func:`run_mesh`, this launcher's BFS pipeline or service.

    Checked before any process starts: N >= 1, for this launcher a BVSS
    engine, and on the card at least N cards.  A rank that fails makes
    the spawn raise (the others are stopped)."""
    n = args.devices
    if n < 1:
        raise ConfigError(f"--devices needs at least one rank, got {n}")
    if run is None:
        engine = ENGINE_VARIANTS[args.engine]["engine"]
        if engine not in (None, *BVSS_ENGINES):
            raise ConfigError(
                f"--devices requires a BVSS engine, not {args.engine}")
        run = run_mesh
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ConfigError(
                f"--devices {n} needs {n} CUDA cards (one rank a card), "
                f"only {have} available; --device cpu runs the ranks on "
                f"the CPU")
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(n, _free_port(), args, threads, run),
             nprocs=n, join=True)


def run_mesh(g, args, mesh, verbose: bool) -> None:
    """One rank's part of ``--devices``: the BFS pipeline or the service."""
    if verbose:
        describe_graph(g, args, mesh)
    if args.service:
        run_service(g, args, mesh=mesh, verbose=verbose)
    else:
        run_bfs(g, args, mesh=mesh, verbose=verbose)


def _rank_main(rank: int, world: int, port: int, args, threads: int,
               run) -> None:
    """One rank of a spawned mesh: join the process group, build the 1-D
    mesh, build the graph and call ``run(g, args, mesh, rank == 0)``
    (rank 0 prints)."""
    import torch.distributed as dist

    torch.set_num_threads(threads)
    backend = "gloo" if args.device == "cpu" else "nccl"
    if args.device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = bfs_mesh(world, device_type=args.device)
        run(build_graph(args.graph, args.scale, args.seed), args, mesh,
            rank == 0)
    finally:
        dist.destroy_process_group()


def describe_graph(g, args, mesh=None) -> None:
    """The launcher's first line: the graph, its class, the device (and
    the mesh's shape)."""
    rep = social_like_report(g)
    print(f"[bfs] graph={args.graph} n={g.n} m={g.m} "
          f"social_like={rep.is_social} (top1={rep.top1_share:.2f} "
          f"slope={rep.ll_slope:.2f}) device={args.device}"
          + (f" mesh={mesh.size()}x1" if mesh is not None else ""),
          flush=True)


def run_bfs(g, args, *, mesh=None, verbose: bool = True) -> None:
    """Prepare ``g`` for the chosen variant (on ``mesh`` when given),
    time ``--sources`` BFSs and check each against the host oracle."""
    def say(line: str) -> None:
        if verbose:
            print(line, flush=True)

    variant = ENGINE_VARIANTS[args.engine]
    t0 = time.time()
    prep = prepare(g, options=PrepareOptions(
        w=512, seed=args.seed, order=variant["order"],
        engine=variant["engine"], device=args.device, mesh=mesh))
    prep_s = time.time() - t0
    if mesh is not None:
        pb = prep.problem
        say(f"[bfs] sharded: {pb.n_shards} shards x "
            f"{pb.rows_per_shard} rows, {pb.num_vss} VSS/shard (padded), "
            f"frontier={pb.n_fwords * 4}B/level all-gather")
    if variant["order"]:
        say(f"[bfs] ordering={prep.ordering} "
            f"(prepare={prep_s:.2f}s incl. BVSS+engine), "
            f"bandwidth={prep.graph.bandwidth()}")
    b = prep.bvss
    say(f"[bfs] BVSS: num_vss={b.num_vss} slices={b.num_slices} "
        f"compression={b.compression_ratio():.3f} "
        f"update_divergence={b.update_divergence():.0f} "
        f"memory={b.memory_bytes()['total'] / 1e6:.1f}MB")
    if variant["engine"] is None:
        say(f"[bfs] policy chose update scheme: {prep.engine_name}")

    rng = np.random.default_rng(args.seed)
    srcs = rng.integers(0, g.n, args.sources)
    lv = prep.levels(int(srcs[0]))  # warm: kernel build, allocator
    times = []
    for s in srcs:
        t0 = time.time()
        lv = prep.levels(int(s))    # ends in a device-to-host copy
        times.append(time.time() - t0)
        if args.verify:
            ref = reference_bfs(g, int(s))
            if not (lv == ref).all():
                raise KernelFaultError(
                    f"{args.engine} levels diverge from the oracle from "
                    f"source {s}")
    reached = int((lv != np.iinfo(np.int32).max).sum())
    say(f"[bfs] {args.engine}: {np.mean(times) * 1e3:.2f} ms/BFS "
        f"(median {np.median(times) * 1e3:.2f}) over {args.sources} "
        f"sources; last run reached {reached}/{g.n} vertices"
        + ("; VERIFIED vs oracle" if args.verify else ""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "urand", "road", "clustered"])
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--engine", default="blest_full",
                    choices=sorted(ENGINE_VARIANTS))
    ap.add_argument("--sources", type=int, default=4)
    ap.add_argument("--verify", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="check levels against the host oracle "
                         "(--no-verify for timing runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run the engines on the card (default) or on the "
                         "CPU through the kernels' PyTorch twins")
    ap.add_argument("--service", action="store_true",
                    help="serve the sources as one batched wave through "
                         "GraphSessionManager instead of sequential BFS "
                         "runs")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="wave slot-pool width for --service")
    ap.add_argument("--queue", action="store_true",
                    help="--service via the async RequestQueue: "
                         "non-blocking submits, futures, mid-flight "
                         "wave coalescing (DESIGN §2.10)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="--service per-call deadline: queries exceeding "
                         "it return partial TimeoutResults instead of "
                         "blocking the wave")
    ap.add_argument("--verify-fraction", type=float, default=0.0,
                    help="--service verify-mode: fraction of wave results "
                         "cross-checked against the host oracle (failing "
                         "sessions are quarantined and re-served on the "
                         "reference path)")
    ap.add_argument("--devices", type=int, default=None,
                    help="row-shard the BFS over a 1-D mesh of N ranks, "
                         "one spawned process each (NCCL on the card, "
                         "gloo under --device cpu)")
    args = ap.parse_args(argv)
    if args.devices is not None:
        spawn_mesh(args, threads=max(1, torch.get_num_threads()
                                     // max(args.devices, 1)))
        return

    g = build_graph(args.graph, args.scale, args.seed)
    describe_graph(g, args)
    if args.service:
        run_service(g, args)
        return
    run_bfs(g, args)


if __name__ == "__main__":
    main()
