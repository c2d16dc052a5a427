"""Mesh-native bench: the sharded stack against its single-device twin,
the port of ``benchmarks/bench_dist.py``::

    PYTHONPATH=src python -m repro_torch.bench.bench_dist --devices 2 \
        --device cpu --scale 8 --json d.json

Per graph of the (small) suite:

* ``engine`` — the fused single-source engine prepared on one device
  against the same preparation with ``mesh=`` (same policy decisions, the
  sharded level loop on every rank).  Both engines' levels are verified
  against ``reference_bfs`` before any time is reported.
* ``serve`` — N level queries through the SHARDED ``GraphSession``, (a)
  one at a time through the sharded single-source engine and (b) as one
  batched wave over the sharded slot pool (mid-flight refills, lock-step
  levels).  Every wave answer is verified against the oracle.
* ``betweenness`` — sampled-source Brandes through the sharded session
  against the single-device session, verified against both (<= 1e-6
  relative sharded against single, 1e-4 against the port's float64
  Brandes oracle).

The reference re-invokes itself with simulated XLA devices; the port
spawns one process a rank instead (:func:`run`): gloo ranks on the CPU
with ``--device cpu``, NCCL ranks on the cards otherwise, one card a rank.
:func:`run_rank` is one rank's part and takes any 1-D mesh, so a caller
that already holds a process group (``chip_smoke.py``'s one NCCL rank)
calls it directly.

``dist2d`` is the reference's ``run_2d`` block: the 2-D engines on
``2 x 2`` and ``4 x 2`` meshes verified against the oracle, and one
level's per-rank communication bytes, 2-D butterfly against the 1-D flat
all-gather on 4 and 8 ranks, read from the port's per-call ledger
(``distributed.collectives.comm_ledger``).  It needs 8 ranks: on fewer
cards it is recorded as not run.  The JSON keys are the reference's
(``graphs.<g>.engine_dist``, ``serve_dist``, ``betweenness_dist``,
``summary.all_verified``, ``dist2d``) under the port's envelope.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.bench.common import (bench_envelope, fmt_row, geomean,
                                      median_sec)
from repro_torch.core.bfs import make_blest_bfs, reference_bfs
from repro_torch.core.policy import PrepareOptions, prepare
from repro_torch.distributed.bfs_dist import bfs_mesh, bfs_mesh2d
from repro_torch.distributed.collectives import comm_ledger
from repro_torch.errors import ConfigError
from repro_torch.graphs import generators as gen
from repro_torch.launch.bfs import _free_port

#: ranks the ``dist2d`` block needs: the 4 x 2 mesh and the flat 8
DIST2D_RANKS = 8


def dist_suite(scale: int) -> dict:
    """Small suite: one social-like and one high-diameter graph (the two
    regimes the update-scheme policy splits on)."""
    side = int((1 << scale) ** 0.5)
    return {
        "kron": gen.rmat(scale, 16, seed=1),
        "road": gen.grid2d(side, side, shuffle=True, seed=3),
    }


def _median_bfs_time(levels_fn, sources) -> float:
    """Median seconds of ``levels_fn(s)`` (a host array) over ``sources``."""
    ts = []
    for s in sources:
        t0 = time.time()
        np.asarray(levels_fn(int(s)))
        ts.append(time.time() - t0)
    return float(np.median(ts))


def run_rank(mesh, scale: int = 8, n_queries: int = 6, device=None,
             verbose: bool = False) -> dict:
    """One rank's part of the bench on the 1-D ``mesh`` (every rank of the
    mesh calls it with the same arguments); every rank returns the same
    result.  ``device`` is the mesh's device type (None: the card)."""
    from repro_torch.kernels.ref import betweenness_ref
    from repro_torch.serve.graph_session import GraphSession

    devices = mesh.size()
    graphs_out = {}
    for gname, g in dist_suite(scale).items():
        rng = np.random.default_rng(0)
        srcs = [int(s) for s in rng.integers(0, g.n, 3)]

        # -- engine: sharded against single-device fused single-source ---
        prep1 = prepare(g, w=512, device=device)
        prepD = prepare(g, w=512, mesh=mesh, device=device)
        verified = True
        for s in srcs:
            ref = reference_bfs(g, s)
            verified &= bool((prep1.levels(s) == ref).all())
            verified &= bool((prepD.levels(s) == ref).all())
        assert verified, f"{gname}: sharded engine diverges from oracle"
        t_1 = _median_bfs_time(prep1.levels, srcs)
        t_D = _median_bfs_time(prepD.levels, srcs)
        engine = {
            "n_sources": len(srcs),
            "single_sec": t_1, "sharded_sec": t_D,
            "ratio_sharded_vs_single": t_D / max(t_1, 1e-12),
            "verified": verified,
        }

        # -- serve: sharded wave against sequential sharded queries -------
        sess = GraphSession(g, max_batch=min(4, n_queries),
                            options=PrepareOptions(w=512, device=device,
                                                   mesh=mesh))
        queries = [int(q) for q in rng.integers(0, g.n, n_queries)]
        sess.levels(queries[0])                        # warm both paths
        sess.levels_batch(queries[: min(2, len(queries))])
        t0 = time.time()
        seq = [sess.levels(q) for q in queries]
        t_seq = time.time() - t0
        t0 = time.time()
        wave = sess.levels_batch(queries)
        t_wave = time.time() - t0
        sverified = all(
            (lv == reference_bfs(g, q)).all() and (lv == lv_s).all()
            for q, lv, lv_s in zip(queries, wave, seq))
        assert sverified, f"{gname}: sharded wave diverges from oracle"
        serve = {
            "n_queries": n_queries, "max_batch": sess.max_batch,
            "sequential_sec": t_seq, "wave_sec": t_wave,
            "speedup": t_seq / max(t_wave, 1e-12), "verified": sverified,
        }

        # -- betweenness: sharded Brandes against single-device ----------
        sess1 = GraphSession(g, max_batch=min(4, n_queries),
                             options=PrepareOptions(w=512, device=device))
        pivots = rng.choice(g.n, size=min(3, g.n), replace=False)
        sess1.betweenness_batch(pivots)                # warm both widths
        sess.betweenness_batch(pivots)
        bc1 = sess1.betweenness_batch(pivots)
        bcD = sess.betweenness_batch(pivots)
        scale_bc = max(float(np.abs(bc1).max()), 1.0)
        rel_err = float(np.abs(bcD - bc1).max()) / scale_bc
        ref_bc = betweenness_ref(g, pivots)
        bverified = bool(
            rel_err <= 1e-6
            and float(np.abs(bcD - ref_bc).max()) / scale_bc < 1e-4)
        assert bverified, f"{gname}: sharded betweenness err {rel_err}"
        t_bc1 = median_sec(lambda: sess1.betweenness_batch(pivots))
        t_bcD = median_sec(lambda: sess.betweenness_batch(pivots))
        bet = {
            "n_pivots": int(len(pivots)),
            "single_sec": t_bc1, "sharded_sec": t_bcD,
            "single_vs_sharded": t_bc1 / max(t_bcD, 1e-12),
            "max_rel_err_vs_single": rel_err, "verified": bverified,
        }

        graphs_out[gname] = {
            "n": int(g.n), "m": int(g.m),
            "ordering": prepD.ordering, "engine": prepD.engine_name,
            "rows_per_shard": int(prepD.problem.rows_per_shard),
            "vss_per_shard": int(prepD.problem.num_vss),
            "frontier_bytes_per_level": int(prepD.problem.n_fwords * 4),
            "engine_dist": engine, "serve_dist": serve,
            "betweenness_dist": bet,
        }
        if verbose:
            ratio = engine["ratio_sharded_vs_single"]
            print(fmt_row(f"bench_dist/{gname}/engine", t_D * 1e6,
                          f"vs_single={ratio:.2f}"))
            print(fmt_row(f"bench_dist/{gname}/serve", t_wave * 1e6,
                          f"speedup={serve['speedup']:.2f}"))
            print(fmt_row(f"bench_dist/{gname}/betweenness", t_bcD * 1e6,
                          f"single_vs_sharded={bet['single_vs_sharded']:.2f}"))

    summary = {
        "geomean_ratio_sharded_vs_single": geomean(
            [go["engine_dist"]["ratio_sharded_vs_single"]
             for go in graphs_out.values()]),
        "geomean_wave_speedup": geomean(
            [go["serve_dist"]["speedup"] for go in graphs_out.values()]),
        "geomean_bc_single_vs_sharded": geomean(
            [go["betweenness_dist"]["single_vs_sharded"]
             for go in graphs_out.values()]),
        "all_verified": all(
            go["engine_dist"]["verified"] and go["serve_dist"]["verified"]
            and go["betweenness_dist"]["verified"]
            for go in graphs_out.values()),
    }
    out = {
        **bench_envelope("pr5_dist", scale, device),
        "devices": devices,
        "note": ("engine = fused single-source BFS, prepared single-device "
                 "vs mesh-native (row-sharded BVSS, the level loop on every "
                 "rank, frontier all-gather + all-reduce convergence); "
                 "serve = sharded GraphSession batched waves vs sequential "
                 "queries through the sharded engine; betweenness = "
                 "mesh-native Brandes (sharded σ forward + reduce-scattered "
                 "backward) vs the single-device session; one process a "
                 "rank (gloo on the CPU, NCCL one card a rank), so ratios "
                 "at world size 1 measure the sharded path's own overhead"),
        "graphs": graphs_out,
        "summary": summary,
    }
    if verbose:
        for k, v in summary.items():
            print(f"# {k}={v if isinstance(v, bool) else f'{v:.2f}x'}")
    return out


def comm_bytes_per_level(problem) -> int:
    """Per-rank communication bytes of ONE BFS level: the fused
    single-source engine cut to one level, run from internal vertex 0
    under the per-call ledger (the reference traces its ``while_loop``
    body once)."""
    fn = make_blest_bfs(problem, lazy=False, max_levels=1)
    with comm_ledger() as events:
        fn(0)
    return int(sum(nb for _, nb in events))


def run_2d_rank(scale: int = 8, device=None, verbose: bool = False
                ) -> dict:
    """One rank's part of the ``dist2d`` block on a process group of at
    least :data:`DIST2D_RANKS` ranks (ranks outside a mesh skip its
    cases); rank 0's result is the block.  ``scale`` is floored at 8
    (below that the 32·cols alignment pads every row block to the same
    size and the volumes degenerate)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    dev_type = "cpu" if device == "cpu" else "cuda"
    scale = max(scale, 8)
    g = dist_suite(scale)["kron"]
    rng = np.random.default_rng(0)
    srcs = [int(s) for s in rng.integers(0, g.n, 3)]
    refs = {s: reference_bfs(g, s) for s in srcs}
    # every rank builds every mesh, in one order, before any is used: a
    # mesh's groups are made by all ranks of the process group together
    meshes = {shape: bfs_mesh2d(*shape, device_type=dev_type)
              for shape in [(2, 2), (4, 2)]}
    flat_meshes = {d: bfs_mesh(d, device_type=dev_type) for d in (4, 8)}

    meshes_out = {}
    verified = True
    for (rows, cols), mesh in meshes.items():
        if rank >= rows * cols:
            continue
        prep = prepare(g, w=512, mesh=mesh, device=device)
        ok = all(bool((prep.levels(s) == refs[s]).all()) for s in srcs)
        assert ok, f"2-D engine diverges from oracle on {rows}x{cols}"
        verified &= ok
        meshes_out[f"{rows}x{cols}"] = {
            "devices": rows * cols,
            "rows_per_shard": int(prep.problem.rows_per_shard),
            "cols_per_block": int(prep.problem.cols_per_block),
            "frontier_words_local": int(prep.problem.n_fwords),
            "median_bfs_sec": _median_bfs_time(prep.levels, srcs),
            "verified": ok,
            "comm_bytes_per_level": comm_bytes_per_level(prep.problem),
        }

    flat = {}
    for d, mesh in flat_meshes.items():
        if rank >= d:
            continue
        prep = prepare(g, w=512, mesh=mesh, device=device)
        flat[d] = comm_bytes_per_level(prep.problem)
    if rank != 0:
        return {}

    b22 = meshes_out["2x2"]["comm_bytes_per_level"]
    b42 = meshes_out["4x2"]["comm_bytes_per_level"]
    comm = {
        "flat_bytes_per_level_4dev": flat[4],
        "flat_bytes_per_level_8dev": flat[8],
        "butterfly_bytes_per_level_2x2": b22,
        "butterfly_bytes_per_level_4x2": b42,
        # >1 means per-rank traffic SHRINKS as the mesh grows 4 -> 8
        "butterfly_shrink_4_to_8": b22 / max(b42, 1),
        "flat_shrink_4_to_8": flat[4] / max(flat[8], 1),
    }
    assert comm["butterfly_shrink_4_to_8"] > 1.0, (
        f"butterfly per-rank bytes/level must shrink with the mesh: "
        f"2x2={b22}B vs 4x2={b42}B")
    assert comm["flat_shrink_4_to_8"] <= 1.0, (
        f"flat all-gather bytes/level should NOT shrink (it grows with "
        f"rank count): 4dev={flat[4]}B vs 8dev={flat[8]}B")
    if verbose:
        for mname, mo in meshes_out.items():
            print(fmt_row(f"bench_dist/dist2d/{mname}",
                          mo["median_bfs_sec"] * 1e6,
                          f"comm={mo['comm_bytes_per_level']}B/level"))
        print(f"# butterfly_shrink_4_to_8="
              f"{comm['butterfly_shrink_4_to_8']:.2f}x "
              f"(flat: {comm['flat_shrink_4_to_8']:.2f}x)")
    return {
        "scale": scale,
        "note": ("per-rank collective payload bytes for ONE level, from the "
                 "per-call ledger: 2-D butterfly (OR-allreduce over columns "
                 "+ segment exchange over rows) vs the 1-D flat frontier "
                 "all-gather; shrink = 4-rank bytes / 8-rank bytes, >1 iff "
                 "traffic shrinks as the mesh grows"),
        "meshes": meshes_out,
        "comm": comm,
        "verified": verified,
    }


# ---------------------------------------------------------------------------
# one process a rank
# ---------------------------------------------------------------------------
def _rank_main(rank: int, world: int, port: int, device: str, part: str,
               kwargs: dict, out_path: str) -> None:
    """One spawned rank: join the group, run ``part`` ("1d": a 1-D mesh
    over every rank, :func:`run_rank`; "2d": :func:`run_2d_rank`), rank 0
    writes the result to ``out_path``."""
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        if part == "1d":
            out = run_rank(bfs_mesh(world, device_type=device),
                           device=device, verbose=rank == 0, **kwargs)
        else:
            out = run_2d_rank(device=device, verbose=rank == 0, **kwargs)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(world: int, device: str, part: str, **kwargs) -> dict:
    """Rank 0's result of ``part`` on ``world`` spawned ranks; checked
    before any process starts: on the card, one card a rank."""
    if world < 1:
        raise ConfigError(f"--devices needs at least one rank, got {world}")
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > have:
            raise ConfigError(
                f"{world} ranks need {world} CUDA cards (one rank a card), "
                f"only {have} available; --device cpu runs the ranks on "
                f"the CPU")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.json")
        mp.spawn(_rank_main, args=(world, _free_port(), device, part, kwargs,
                                   path), nprocs=world, join=True)
        with open(path) as f:
            return json.load(f)


def run(scale: int = 8, devices: int = 2, n_queries: int = 6,
        device: str = "cuda", json_path: str | None = None,
        verbose: bool = True) -> dict:
    """The whole bench: :func:`run_rank` on ``devices`` spawned ranks,
    then the ``dist2d`` block on :data:`DIST2D_RANKS` ranks of the same
    device type (recorded as not run where fewer cards exist)."""
    out = _spawn(devices, device, "1d", scale=scale, n_queries=n_queries)
    have = DIST2D_RANKS if device == "cpu" else (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if have >= DIST2D_RANKS:
        out["dist2d"] = _spawn(DIST2D_RANKS, device, "2d", scale=scale)
    else:
        out["dist2d"] = {"not_run": f"needs {DIST2D_RANKS} ranks, one a "
                                    f"card; {have} cards here"}
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=False)
        if verbose:
            print(f"# wrote {json_path}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--queries", type=int, default=6)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(scale=args.scale, devices=args.devices, n_queries=args.queries,
        device=args.device, json_path=args.json)


if __name__ == "__main__":
    main()
