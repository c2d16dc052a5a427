"""Run a program on a gloo process group of CPU ranks, for the port's mesh
tests (``tests/test_torch_distributed*.py``).

:func:`run_ranks` spawns ``world`` processes, each joining one gloo group
over a TCP store on 127.0.0.1 with one torch thread (the setting of
``torch_one_thread.py``), runs ``program(rank, world)`` in each, and
returns every rank's result (a picklable value), in rank order.  The whole
spawn runs under its own timeout: a hung collective fails the calling test
instead of eating the suite's time limit.

The programs live in this module, which imports neither JAX nor the JAX
package, so each rank starts with torch and the port alone.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, program, outdir: str,
                timeout: float) -> None:
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = program(rank, world)
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)          # the spawn stops the other ranks
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(program, world: int, *, timeout: float = 240.0) -> list:
    """``[program(0, world), ..., program(world - 1, world)]``, each run
    on its own rank of a fresh gloo group; a rank's exception, or a spawn
    past ``timeout`` seconds, raises ``AssertionError`` here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as outdir:
        ctx = mp.spawn(_rank_entry, args=(world, _free_port(), program,
                                          outdir, timeout),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        failure = None
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    failure = f"ran past {timeout} s"
                    break
        except Exception as e:   # noqa: BLE001 - a rank exited non-zero
            failure = str(e)
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        errors = [open(os.path.join(outdir, name)).read()
                  for name in sorted(os.listdir(outdir))
                  if name.endswith(".err")]
        assert failure is None and not errors, \
            f"{program.__name__} on {world} ranks: {failure}\n" + \
            "\n".join(errors)
        results = []
        for rank in range(world):
            with open(os.path.join(outdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _raises(fn, *args, **kwargs) -> str | None:
    """The class name and message of what ``fn`` raises, or None."""
    try:
        fn(*args, **kwargs)
    except Exception as e:       # noqa: BLE001 - the result is compared
        return f"{type(e).__name__}: {e}"
    return None


@contextlib.contextmanager
def count_host_reads():
    """Count the calls that copy a tensor's value to the host
    (``Tensor.tolist``, ``Tensor.item``, ``bool(tensor)``) while open: on
    the card each is one device-to-host copy."""
    import torch
    reads = [0]
    saved = {k: getattr(torch.Tensor, k)
             for k in ("tolist", "item", "__bool__")}

    def counted(orig):
        def wrapper(self, *args, **kwargs):
            reads[0] += 1
            return orig(self, *args, **kwargs)
        return wrapper

    for k, orig in saved.items():
        setattr(torch.Tensor, k, counted(orig))
    try:
        yield reads
    finally:
        for k, orig in saved.items():
            setattr(torch.Tensor, k, orig)


# ---------------------------------------------------------------------------
# 1-D mesh program (tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------
SWEEP_RANKS = (1, 2, 8)
BVSS_ENGINES = ("blest", "blest_lazy", "brs")
ENGINE_RANKS = 4
WEIGHT_RANKS = 2


def sweep_graphs():
    from repro_torch.graphs import generators as gen
    return {"rmat": gen.rmat(8, 8, seed=3), "grid": gen.grid2d(20, 16)}


def engine_graph():
    from repro_torch.graphs import generators as gen
    return gen.rmat(8, 8, seed=5)


def weights_of(g) -> np.ndarray:
    """Dyadic weights k/32 drawn from a seed, one per CSR edge."""
    rng = np.random.default_rng(11)
    return (rng.integers(1, 64, g.m) / 32.0).astype(np.float32)


def sources_of(g) -> tuple[int, int, int]:
    return (0, g.n // 3, g.n - 1)


def program_1d(rank: int, world: int) -> dict:
    """Every 1-D case, on sub-meshes of the first P ranks; results keyed by
    case, from every rank of the case's mesh."""
    import repro_torch as rt
    from repro_torch.core.bfs import make_blest_bfs, make_engine
    from repro_torch.distributed import bfs_mesh, comm_ledger
    out: dict = {}
    meshes = {P: bfs_mesh(P, device_type="cpu")
              for P in sorted({*SWEEP_RANKS, ENGINE_RANKS, WEIGHT_RANKS})}
    out["over_request"] = _raises(bfs_mesh, world + 1, device_type="cpu")
    out["cuda_over_request"] = _raises(bfs_mesh, 1)
    for P in SWEEP_RANKS:
        if rank >= P:
            continue
        for name, g in sweep_graphs().items():
            pb = rt.prepare(g, w=256, mesh=meshes[P], device="cpu")
            out[("sweep", P, name)] = {
                "engine": pb.engine_name,
                "levels": [pb.levels(s) for s in sources_of(g)]}
            # one level's traffic: the engine cut to one level
            fn = make_blest_bfs(pb.problem, lazy=False, max_levels=1)
            with comm_ledger() as events:
                fn(int(pb.perm[0]))
            out[("ledger", P, name)] = {
                "events": list(events),
                "lwords": pb.problem.rows_per_shard // 32}
            for eng in BVSS_ENGINES:
                pb = rt.prepare(g, w=256, mesh=meshes[P], device="cpu",
                                engine=eng)
                out[("sweep_engine", P, name, eng)] = [
                    pb.levels(s) for s in sources_of(g)]
    if rank < ENGINE_RANKS:
        mesh, g = meshes[ENGINE_RANKS], engine_graph()
        for eng in ("blest", "blest_lazy", "brs"):
            for use_kernels in (True, False):
                directions = ("auto",) if eng == "brs" else \
                    ("auto", "pull", "push")
                for direction in directions:
                    pb = rt.prepare(g, w=256, mesh=mesh, device="cpu",
                                    engine=eng, use_kernels=use_kernels,
                                    direction=direction)
                    out[("engine", eng, use_kernels, direction)] = [
                        pb.levels(s) for s in (0, g.n - 1)]
        pb = rt.prepare(g, w=256, mesh=mesh, device="cpu", autotune=True)
        out["autotune"] = {"levels": [pb.levels(s) for s in (0, g.n - 1)],
                           "tile_config": pb.tile_config is not None}
        out["non_bvss"] = _raises(rt.prepare, g, mesh=mesh, device="cpu",
                                  engine="csr_push")
        out["device_mismatch"] = _raises(rt.prepare, g, mesh=mesh)
        out["bad_axis"] = _raises(rt.prepare, g, mesh=mesh, device="cpu",
                                  mesh_axis="rows")
        out["update_edges"] = _raises(rt.apply_edge_updates, pb,
                                      inserts=[(0, 1)])
        out["multi_source"] = _raises(make_engine, g, "multi_source",
                                      problem=pb.problem, n_sources=2)
        out["session"] = _raises(
            rt.GraphSession, g, options=rt.PrepareOptions(device="cpu",
                                                          mesh=mesh))
    if rank < WEIGHT_RANKS:
        g = engine_graph()
        for eng in ("blest", "blest_lazy", "brs"):
            pb = rt.prepare(g, w=256, mesh=meshes[WEIGHT_RANKS],
                            device="cpu", engine=eng)
            with count_host_reads() as reads, comm_ledger() as events:
                pb.levels(0)
            out[("host_reads", eng)] = {"reads": reads[0],
                                        "levels": len(events)}
        pb = rt.prepare(g, w=256, order=False, mesh=meshes[WEIGHT_RANKS],
                        device="cpu", weights=weights_of(g))
        out["wplane"] = pb.wplane.numpy()
        out["wplane_levels"] = pb.levels(0)
    return out


# ---------------------------------------------------------------------------
# 2-D mesh and butterfly program (tests/test_torch_distributed_2d.py)
# ---------------------------------------------------------------------------
MESHES_2D = ((1, 1), (2, 1), (2, 2), (4, 2))
BUTTERFLY_RANKS = (2, 3, 4, 8)


def butterfly_words(n: int) -> np.ndarray:
    """The reference test's operand: (8n, 3) uint32 words from a seed
    ((9, 2) on the 3-rank fallback), rank d's block d."""
    if n == 3:
        return np.random.default_rng(1).integers(0, 2 ** 32, (9, 2),
                                                 dtype=np.uint32)
    return np.random.default_rng(0).integers(0, 2 ** 32, (8 * n, 3),
                                             dtype=np.uint32)


def clustered_graph():
    from repro_torch.graphs import generators as gen
    return gen.clustered(3, 23, seed=4)


def isolated_graph():
    from repro_torch.graphs import from_edges
    return from_edges(50, [1, 2, 10], [2, 3, 11])


def path_graph(n: int = 70):
    from repro_torch.graphs import from_edges
    return from_edges(n, np.arange(n - 1), np.arange(1, n))


def program_2d(rank: int, world: int) -> dict:
    """Every 2-D and butterfly case, on sub-meshes of the first ranks."""
    import torch

    import repro_torch as rt
    from repro_torch.core.bfs import make_blest_bfs
    from repro_torch.distributed import (bfs_mesh, bfs_mesh2d,
                                         butterfly_frontier_exchange,
                                         butterfly_or_allreduce,
                                         comm_ledger)
    from repro_torch.distributed.collectives import all_gather_tiled
    out: dict = {}
    flat = {n: bfs_mesh(n, "x", device_type="cpu") for n in BUTTERFLY_RANKS}
    meshes = {s: bfs_mesh2d(*s, device_type="cpu") for s in MESHES_2D}
    out["over_request"] = _raises(bfs_mesh2d, 4, 3, device_type="cpu")
    for n, mesh in flat.items():
        if rank >= n:
            continue
        words = butterfly_words(n)
        seg = torch.from_numpy(
            words.view(np.int32).reshape((n, -1) + words.shape[1:])[rank]
            .copy())
        with comm_ledger() as ev_bf:
            got = butterfly_frontier_exchange(seg, mesh, "x")
        with comm_ledger() as ev_or:
            got_or = butterfly_or_allreduce(seg, mesh, "x")
        stalled = butterfly_frontier_exchange(seg, mesh, "x", stall_stage=0)
        out[("butterfly", n)] = {
            "exchange": got.numpy().view(np.uint32),
            "flat": all_gather_tiled(seg, mesh.get_group("x"))
            .numpy().view(np.uint32),
            "or": got_or.numpy().view(np.uint32),
            "stalled": stalled.numpy().view(np.uint32),
            "ledger_exchange": list(ev_bf), "ledger_or": list(ev_or)}
    for shape, mesh in meshes.items():
        if rank >= shape[0] * shape[1]:
            continue
        g = clustered_graph()
        for eng in ("blest", "blest_lazy"):
            pb = rt.prepare(g, w=256, mesh=mesh, device="cpu", engine=eng)
            out[("clustered", shape, eng)] = [pb.levels(s)
                                              for s in sources_of(g)]
        fn = make_blest_bfs(pb.problem, lazy=False, max_levels=1)
        with comm_ledger() as events:
            fn(int(pb.perm[0]))
        out[("ledger", shape)] = {
            "events": list(events),
            "lwords": pb.problem.rows_per_shard // 32,
            "wpc": pb.problem.cols_per_block // 32}
        if shape in ((2, 2), (4, 2)):
            gp = path_graph()
            pb = rt.prepare(gp, w=256, order=False, mesh=mesh, device="cpu")
            out[("path", shape)] = [pb.levels(s)
                                    for s in (0, gp.n - 1, gp.n // 2)]
        if shape == (2, 2):
            gi = isolated_graph()
            pb = rt.prepare(gi, w=256, order=False, mesh=mesh, device="cpu")
            out["isolated"] = [pb.levels(s) for s in (0, 1, 10, 49)]
            out["push"] = _raises(rt.prepare, g, w=256, mesh=mesh,
                                  device="cpu", direction="push")
            pb = rt.prepare(g, w=256, mesh=mesh, device="cpu",
                            direction="auto")
            out["auto"] = pb.levels(0)
            out["brs"] = _raises(rt.prepare, g, mesh=mesh, device="cpu",
                                 engine="brs")
            out["weights"] = _raises(rt.prepare, g, mesh=mesh, device="cpu",
                                     weights=weights_of(g))
    return out
