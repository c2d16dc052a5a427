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
import dataclasses
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


def same_graph(tg, jg) -> None:
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)


def each_rank(ranks: list, key, P: int = 2):
    """``key``'s result on every rank of the P-rank mesh, all equal to rank
    0's (SPMD: every rank gets the whole answer)."""
    got = [r[key] for r in ranks[:P]]
    for other in got[1:]:
        assert_same(other, got[0])
    return got[0]


def assert_same(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif a is None or isinstance(a, (str, bool, int, float)):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


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


UPDATE_RANKS = (2, 8)
UPDATE_ROUNDS = 3


def update_graph():
    """``tests/test_bvss_delta.py``'s graph."""
    from repro_torch.graphs import generators as gen
    return gen.rmat(7, 8, seed=21)


def update_batches(n: int, weighted: bool) -> list:
    """``test_sharded_update_matches_single_device``'s three rounds of
    inserts (caller ids), with dyadic weights on a weighted preparation."""
    rng = np.random.default_rng(6)
    out = []
    for _ in range(UPDATE_ROUNDS):
        ins = sorted({(int(a), int(b))
                      for a, b in rng.integers(0, n, (4, 2)) if a != b})
        out.append((ins, (np.arange(1, len(ins) + 1) / 8.0).astype(
            np.float32) if weighted else None))
    return out


def missing_edge(g) -> tuple[int, int]:
    """The first ``(a, b)``, ``a != b``, that is not an edge of ``g``
    (``tests/test_bvss_delta.py``'s ``_missing_edge``)."""
    from repro_torch.graphs import src_of_edges
    have = set(zip(src_of_edges(g).tolist(), g.indices.tolist()))
    return next((a, b) for a in range(g.n) for b in range(g.n)
                if a != b and (a, b) not in have)


def rank_block(prep) -> dict:
    """This rank's sharded block of ``prep`` on the host (the appended
    dummy VSS cut off) and the ordered graph it encodes."""
    dev = prep.problem.dev
    out = {"masks": dev.masks[:-1].numpy().view(np.uint32),
           "row_ids": dev.row_ids[:-1].numpy(),
           "indptr": prep.graph.indptr, "indices": prep.graph.indices,
           "report": dataclasses.asdict(prep.last_update)
           if prep.last_update is not None else None}
    if prep.wplane is not None:
        out["wplane"] = prep.wplane[:-1].numpy()
        out["weights"] = prep.weights
    return out


def shard_structural_batch(prep) -> list:
    """One insert (caller ids) from a slice set that has no slice in the
    last shard holding rows but keeps its global VSS count: the per-shard
    check alone sends it to a rebuild."""
    b, pb = prep.bvss, prep.problem
    sigma, n = b.sigma, b.n
    d = (n - 1) // pb.rows_per_shard
    lo = d * pb.rows_per_shard
    t_indptr, t_indices = prep.graph.t_csr
    rows = np.repeat(np.arange(n), np.diff(t_indptr))
    for I in range(b.n_sets):
        count = len(np.unique(rows[(t_indices // sigma) == I]))
        if pb.shard_ptrs[d, I + 1] == pb.shard_ptrs[d, I] and count \
                and count % b.tau and I * sigma != lo:
            return [(int(prep.inv[I * sigma]), int(prep.inv[lo]))]
    raise AssertionError("no set leaves the last shard empty")


def program_1d(rank: int, world: int) -> dict:
    """Every 1-D case, on sub-meshes of the first P ranks; results keyed by
    case, from every rank of the case's mesh."""
    import torch

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
    for P in UPDATE_RANKS:
        if rank >= P:
            continue
        # tests/test_bvss_delta.py's sharded rounds, unweighted and weighted
        g = update_graph()
        for weighted in (False, True):
            prep = rt.prepare(g, w=512, seed=0, mesh=meshes[P], device="cpu",
                              weights=weights_of(g) if weighted else None)
            rounds = []
            for ins, w in update_batches(g.n, weighted):
                before = prep.problem.dev.masks.clone()
                old = prep
                prep = rt.apply_edge_updates(prep, inserts=ins,
                                             insert_weights=w)
                rounds.append({
                    **rank_block(prep),
                    "old_untouched": bool(torch.equal(old.problem.dev.masks,
                                                      before)),
                    "levels": [prep.levels(s) for s in (0, g.n // 3)]})
            out[("update", P, weighted)] = rounds
        # a batch only the per-shard check sends to a rebuild
        prep = rt.prepare(g, w=512, seed=0, mesh=meshes[P], device="cpu")
        ins = shard_structural_batch(prep)
        prep = rt.apply_edge_updates(prep, inserts=ins)
        out[("update_shard", P)] = {
            "inserts": ins, **rank_block(prep),
            "levels": [prep.levels(s) for s in sources_of(g)]}
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
        # edge updates on the mesh (once refused here, queue 1 item 11e)
        pb2 = rt.apply_edge_updates(pb, inserts=[missing_edge(g)])
        out["update_edges"] = {
            "report": dataclasses.asdict(pb2.last_update),
            "levels": [pb2.levels(s) for s in (0, g.n - 1)]}
        # the multi-source engine and a session on the mesh (once refused
        # here, queue 1 item 11c): levels in caller ids
        ms = make_engine(g, "multi_source", problem=pb.problem, n_sources=2)
        lv = ms(pb.perm[[0, g.n - 1]]).numpy()
        out["multi_source"] = [lv[pb.perm, k] for k in range(2)]
        sess = rt.GraphSession(g, options=rt.PrepareOptions(device="cpu",
                                                            mesh=mesh))
        out["session"] = sess.levels_batch([0, g.n - 1])
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
    # benchmarks/bench_dist.py's run_2d block, on all 8 ranks
    from repro_torch.bench import bench_dist
    out["bench_dist_2d"] = bench_dist.run_2d_rank(scale=9, device="cpu")
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


# ---------------------------------------------------------------------------
# the wave marks: fused into the bit-SpMM, or through the spmm_impl seam
# ---------------------------------------------------------------------------
FUSED_RANKS = (2, 8)
FUSED_SHAPES_2D = ((2, 2), (4, 2))


def fused_and_seam(problem, direction: str, queries) -> dict:
    """The wave engine on ``problem`` with its marks stored by the fused
    ``bvss_spmm_mark`` and, beside it, with the ``spmm_impl`` seam (the
    unfused ``bvss_spmm_ref`` counts and one indexed store): the first
    three ``queries`` as one fixed cohort (``make_multi_source_bfs`` for
    the fused path, the seam engine's own level loop), then every query
    through ``drive_wave`` with refills.  Levels are in the problem's row
    ids, keyed by source."""
    from repro_torch.core.multi_source import (drive_wave, make_ms_engine,
                                               make_multi_source_bfs)
    from repro_torch.kernels.ref import bvss_spmm_ref
    cohort = np.asarray(queries[:3])
    out = {}
    for name, seam in (("fused", None), ("seam", bvss_spmm_ref)):
        eng = make_ms_engine(problem, 3, direction=direction, spmm_impl=seam)
        if seam is None:
            fixed = make_multi_source_bfs(None, 3, problem=problem,
                                          direction=direction)(cohort)
        else:
            st = eng.init(cohort)
            while st.cont:
                st, _ = eng.level_step(st)
            fixed = eng.levels_of(st, None)
        pending, owner, answers = list(queries), {}, {}

        def next_source(slot):
            if not pending:
                return None
            owner[slot] = pending.pop()
            return owner[slot]

        steps = drive_wave(eng, next_source,
                           lambda slot, lv: answers.__setitem__(owner[slot],
                                                                lv))
        out[name] = {"cohort": fixed.numpy(), "wave": answers,
                     "levels": steps}
    return out


def check_fused_and_seam(got: dict, g, queries, direction: str) -> None:
    """The fused and the seam paths of :func:`fused_and_seam` give the
    same levels and level counts, each answer equal to the host BFS of
    ``g``."""
    from repro_torch.core.bfs import reference_bfs
    assert_same(got["fused"], got["seam"])
    assert got["fused"]["levels"] > 0, direction
    for i, s in enumerate(queries[:3]):
        np.testing.assert_array_equal(got["fused"]["cohort"][:, i],
                                      reference_bfs(g, int(s)))
    assert sorted(got["fused"]["wave"]) == sorted(set(queries))
    for s, lv in got["fused"]["wave"].items():
        np.testing.assert_array_equal(lv, reference_bfs(g, int(s)))


def fused_graph():
    from repro_torch.graphs import generators as gen
    return gen.rmat(7, 8, seed=2)


# ---------------------------------------------------------------------------
# mesh sessions, 1-D (tests/test_torch_mesh_session.py)
# ---------------------------------------------------------------------------
SESSION_RANKS = (1, 2, 8)
VERB_QUERIES = [0, 5, 19, 64, 100, 5, 127]
FAULT_QUERIES = [0, 5, 19, 64]
SKEW_QUERIES = [0, 1, 2, 3]
QUEUE_QUERIES = [3, 17, 29, 41, 55, 60, 71, 88, 96, 104, 113, 127]


def dyadic(rng, m: int) -> np.ndarray:
    """Dyadic weights k/32 (exact float32 path sums), one per CSR edge."""
    return (rng.integers(1, 128, m) / 32.0).astype(np.float32)


def verbs_graph():
    from repro_torch.graphs import generators as gen
    return gen.rmat(7, 8, seed=19)


def bc_graphs():
    """The reference's sharded-Brandes graphs: ragged n = 69, and one with
    an isolated source (its column empties at level 1)."""
    from repro_torch.graphs import from_edges
    from repro_torch.graphs import generators as gen
    return [gen.clustered(3, 23, seed=4),
            from_edges(50, np.array([1, 2, 10]), np.array([2, 3, 11]))]


def bc_sources(g) -> np.ndarray:
    return np.array([1, min(40, g.n - 1), 2, g.n - 1], dtype=np.int64)


def degenerate_graphs() -> dict:
    """``tests/test_validation.py``'s DEGENERATE cases, on the port's
    graphs."""
    from repro_torch.graphs import Graph, from_edges

    def empty(n):
        return Graph(n, np.zeros(n + 1, dtype=np.int64),
                     np.zeros(0, dtype=np.int32))
    return {
        "single-vertex": (empty(1), [0]),
        "zero-edge": (empty(40), [0, 17, 39]),
        "all-isolated-but-one-edge": (
            from_edges(40, np.array([0]), np.array([1])), [0, 1, 25]),
        "source-in-empty-component": (
            from_edges(50, np.arange(10), np.arange(1, 11)), [45, 0, 49]),
    }


def bad_weight_cases(m: int) -> dict:
    w = np.ones(m, dtype=np.float32)
    nan, neg, zero, inf = w.copy(), w.copy(), w.copy(), w.copy()
    nan[m // 2], neg[0], zero[-1], inf[0] = np.nan, -1.0, 0.0, np.inf
    return {"shape": np.ones(m + 1, dtype=np.float32), "nan": nan,
            "negative": neg, "zero": zero, "inf": inf}


def session_update_batch(g) -> tuple:
    """An update of the verbs graph (caller ids): two fresh inserts and a
    reweight of an existing edge (with dyadic weights), two deletes."""
    from repro_torch.graphs import src_of_edges
    src, dst = src_of_edges(g), g.indices
    have = set(zip(src.tolist(), dst.tolist()))
    fresh = [(a, b) for a, b in ((0, 1), (5, 77), (100, 3), (9, 120))
             if (a, b) not in have][:2]
    inserts = fresh + [(int(src[7]), int(dst[7]))]
    deletes = [(int(src[k]), int(dst[k])) for k in (3, 40)]
    return inserts, np.array([0.25, 1.5, 0.0625], np.float32), deletes


def _mesh_update(rt, mgr, name: str, sess, g) -> dict:
    """``update_edges`` through the manager on a weighted mesh session,
    then a wave, ``sssp_batch`` and ``pagerank`` on the new epoch."""
    ins, w, dels = session_update_batch(g)
    report = mgr.update_edges(name, ins, dels, insert_weights=w)
    q = VERB_QUERIES
    return {"report": dataclasses.asdict(report), "epoch": sess.epoch,
            "wave": mgr.levels_batch(name, q),
            "sssp_batch": sess.sssp_batch(q[:3]),
            "pagerank": sess.pagerank(tol=1e-10, max_iter=500)}


def _faulted(rt, g, opts, plan) -> dict:
    """A stall plan through a verifying manager, and on a bare session."""
    import warnings
    mgr = rt.GraphSessionManager(verify_fraction=1.0)
    mgr.open_session("stalled", g, max_batch=2, options=opts,
                     fault_plan=plan)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        verified = mgr.levels_batch("stalled", FAULT_QUERIES)
    sess = rt.GraphSession(g, max_batch=2, options=opts, fault_plan=plan)
    return {"verified": verified, "stats": mgr.stats(),
            "degraded": sum(issubclass(w.category, rt.DegradedServiceWarning)
                            for w in caught),
            "unverified": sess.levels_batch(FAULT_QUERIES)}


def program_session_1d(rank: int, world: int) -> dict:
    """Every 1-D session case, on sub-meshes of the first P ranks; results
    keyed by case, from every rank of the case's mesh."""
    import time

    import repro_torch as rt
    from repro_torch.analytics.betweenness import make_betweenness
    from repro_torch.core.bfs import BlestProblem
    from repro_torch.core.bvss import build_sharded_bvss
    from repro_torch.core.multi_source import make_ms_engine
    from repro_torch.distributed import bfs_mesh
    from repro_torch.graphs import from_edges
    from repro_torch.graphs import generators as gen
    meshes = {P: bfs_mesh(P, device_type="cpu") for P in SESSION_RANKS}
    out: dict = {}

    def opts(P, **kw):
        return rt.PrepareOptions(device="cpu", mesh=meshes[P], **kw)

    for P in SESSION_RANKS:
        if rank >= P:
            continue
        # the seven verbs on one weighted session, opened by the manager
        g = verbs_graph()
        mgr = rt.GraphSessionManager()
        sess = mgr.open_session("verbs", g, max_batch=3, options=opts(
            P, w=256, weights=dyadic(np.random.default_rng(20), g.m)))
        q = VERB_QUERIES
        out[("verbs", P)] = {
            "levels": sess.levels(q[1]),
            "levels_batch": mgr.levels_batch("verbs", q),
            "components": sess.components(),
            "eccentricity": sess.eccentricity_batch(q[:5]),
            "closeness": sess.closeness_batch(q[:5]),
            "betweenness": sess.betweenness_batch(q[:4]),
            "sssp_batch": sess.sssp_batch(q[:3]),
            "sssp": sess.sssp(q[4]),
            "pagerank": sess.pagerank(tol=1e-10, max_iter=500),
            "bytes": mgr.bytes_used(),
            "problems_sharded": all(
                v.mesh is not None for v in sess._analytics_cache.values()
                if isinstance(v, BlestProblem)),
            "update_edges": _mesh_update(rt, mgr, "verbs", sess, g)}
        # Brandes across device counts, the kernel path and the twins'
        for gi, gb in enumerate(bc_graphs()):
            pD = BlestProblem.build_sharded(build_sharded_bvss(gb, P),
                                            meshes[P], device="cpu")
            for use_kernel in (True, False):
                f = make_betweenness(pD, 4, use_kernel=use_kernel)
                out[("bc", P, gi, use_kernel)] = [
                    x.numpy() for x in f(bc_sources(gb))]
        if P == 1:
            continue
        # the wave marks, fused and through the seam, in every direction
        if P in FUSED_RANKS:
            sess = rt.GraphSession(fused_graph(), max_batch=3,
                                   options=opts(P, order=False))
            out[("fused", P)] = {
                d: fused_and_seam(sess._problem, d, VERB_QUERIES)
                for d in ("auto", "pull", "push")}
        # the caller-id contract: refills, a duplicate, mixed depths
        g = gen.rmat(8, 8, seed=1)
        sess = rt.GraphSession(g, max_batch=3, options=opts(P, w=256))
        rng = np.random.default_rng(0)
        queries = [int(x) for x in rng.integers(0, g.n, 7)]
        queries[3] = queries[0]
        g2 = from_edges(60, np.arange(59), np.arange(1, 60))
        sess2 = rt.GraphSession(g2, max_batch=2, options=opts(P,
                                                              order=False))
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            srcs, cc = sess.centrality_sample(5, seed=2)
        out[("caller_ids", P)] = {
            "ordering": sess.ordering, "moved": bool(
                (sess.perm != np.arange(g.n)).any()),
            "queries": queries, "levels": sess.levels_batch(queries),
            "path": sess2.levels_batch([58, 0, 55, 2, 59]),
            "sample": (srcs, cc)}
    if rank >= 2:
        return out
    mesh2 = meshes[2]
    # benchmarks/bench_dist.py's 1-D part, small
    from repro_torch.bench import bench_dist
    out["bench_dist"] = bench_dist.run_rank(mesh2, scale=6, n_queries=4,
                                            device="cpu")
    # the reference's two-device parity cases (tests/test_analytics.py)
    g = gen.rmat(6, 8, seed=1)
    sess = rt.GraphSession(g, max_batch=4, options=opts(2))
    srcs = np.random.default_rng(4).integers(0, g.n, 4)
    out["parity_rmat"] = {"components": sess.components(),
                          "betweenness": sess.betweenness_batch(srcs)}
    g = gen.grid2d(8, 8, shuffle=True, seed=3)
    sess = rt.GraphSession(g, max_batch=4, options=opts(2))
    out["parity_ecc"] = sess.eccentricity_batch(
        np.random.default_rng(5).integers(0, g.n, 5))
    g = gen.clustered(3, 16, seed=4)
    sess = rt.GraphSession(g, max_batch=4, options=opts(2))
    srcs = np.random.default_rng(8).integers(0, g.n, 5)
    out["parity_closeness"] = {"sampled": sess.closeness_batch(srcs),
                               "exact": sess.closeness_batch()}
    # σ channel through a mid-flight refill, on the host-driven surface
    g = gen.rmat(6, 8, seed=3)
    eng = make_ms_engine(BlestProblem.build_sharded(
        build_sharded_bvss(g, 2), mesh2, device="cpu"), 2, track_sigma=True)
    st = eng.init(np.array([5, 9]))
    for refill in (True, False):
        for _ in range(g.n):
            st, live = eng.level_step(st)
            if not live.any():
                break
        if refill:
            st = eng.insert_batch(st, np.array([23, 0]),
                                  np.array([True, False]))
    out["sigma_refill"] = [eng.paths_of(st, slot).numpy() for slot in (0, 1)]
    # the weighted verbs' own cases (tests/test_weighted_verbs.py)
    g = gen.rmat(7, 8, seed=19)
    sess = rt.GraphSession(g, options=opts(2, weights=dyadic(
        np.random.default_rng(20), g.m)))
    out["sssp"] = sess.sssp_batch([0, 9])
    g = gen.rmat(7, 8, seed=21)
    out["pagerank"] = rt.GraphSession(g, options=opts(2)).pagerank(
        tol=1e-10, max_iter=500)
    g = gen.rmat(6, 4, seed=22)
    out["bad_weights"] = {case: _raises(rt.GraphSession, g,
                                        options=opts(2, weights=bad))
                          for case, bad in bad_weight_cases(g.m).items()}
    # the stall seam (tests/test_faults.py), and the degenerate graphs
    # (tests/test_validation.py)
    out["stall_shard"] = _faulted(rt, gen.rmat(7, 8, seed=2), opts(2),
                                  rt.FaultPlan(stall_shard=1))
    out["degenerate"] = {
        case: rt.GraphSession(gd, max_batch=2, options=opts(
            2, order=False)).levels_batch(sources)
        for case, (gd, sources) in degenerate_graphs().items()}
    # a deadline that rank 1 would call differently: rank 0's call counts
    g2 = from_edges(60, np.arange(59), np.arange(1, 60))
    sess = rt.GraphSession(g2, max_batch=2, options=opts(2, order=False))
    asked = {i: 0 for i in range(len(SKEW_QUERIES))}
    partial: dict = {}

    def should_harvest(i):
        asked[i] += 1
        return (i == 1 and asked[i] == 3) if rank == 0 else i == 0

    got = sess.levels_batch(SKEW_QUERIES, should_harvest=should_harvest,
                            on_harvested=partial.__setitem__)
    out["skew"] = {"levels": got, "partial": partial}
    # the async queue over the 2-rank session: the pump drains while the
    # ranks submit on their own timing
    g = gen.rmat(7, 8, seed=2)
    mgr = rt.GraphSessionManager(verify_fraction=1.0)
    mgr.open_session("q", g, max_batch=4, options=opts(2))
    queue = rt.RequestQueue(mgr)
    queue.start(poll_s=0.001)
    futs = []
    for src in QUEUE_QUERIES:
        futs.append(queue.submit("q", src))
        time.sleep(0.003 * (rank + 1))
    queue.stop(drain=True)
    out["queue"] = {"levels": [f.result(0) for f in futs],
                    "stats": queue.stats(), "manager": mgr.stats()}
    # an edge update through the manager between two drains of a queue
    # over the mesh session: the second drain answers the new epoch
    report = mgr.update_edges("q", inserts=[missing_edge(g)])
    queue = rt.RequestQueue(mgr)
    futs = [queue.submit("q", src) for src in QUEUE_QUERIES[:4]]
    queue.drain(wait=True)
    out["queue_update"] = {"report": dataclasses.asdict(report),
                           "levels": [f.result(0) for f in futs],
                           "manager": mgr.stats()}
    return out


# ---------------------------------------------------------------------------
# mesh sessions, 2-D (tests/test_torch_mesh_session_2d.py)
# ---------------------------------------------------------------------------
SESSION_MESHES_2D = ((1, 1), (2, 2), (4, 2))
SESSION_QUERIES_2D = [0, 7, 23, 7, 68]
UPDATE_2D = [(0, 50), (7, 3), (60, 2)]
BC_SOURCES_2D = [0, 5, 23, 41]


def program_session_2d(rank: int, world: int) -> dict:
    """Every 2-D session case, on sub-meshes of the first ranks."""
    import repro_torch as rt
    from repro_torch.core.multi_source import make_ms_engine
    from repro_torch.distributed import bfs_mesh2d
    from repro_torch.graphs import generators as gen
    meshes = {s: bfs_mesh2d(*s, device_type="cpu")
              for s in {*SESSION_MESHES_2D, (2, 1)}}
    out: dict = {}

    def opts(shape, **kw):
        return rt.PrepareOptions(device="cpu", mesh=meshes[shape], **kw)

    for shape in SESSION_MESHES_2D:
        if rank >= shape[0] * shape[1]:
            continue
        # tests/test_distributed_2d.py's transparency case, with every
        # verb the reference serves on a 2-D mesh
        g = clustered_graph()
        sess = rt.GraphSession(g, max_batch=3, options=opts(shape, w=256))
        q = SESSION_QUERIES_2D
        out[("session", shape)] = {
            "levels_batch": sess.levels_batch(q),
            "levels": sess.levels(q[2]),
            "betweenness": sess.betweenness_batch(BC_SOURCES_2D),
            "components": sess.components(),
            "eccentricity": sess.eccentricity_batch(q[:4]),
            "closeness": sess.closeness_batch(q[:4]),
            "sssp": _raises(sess.sssp, 0),
            "pagerank": _raises(sess.pagerank),
            "push": _raises(make_ms_engine, sess._problem, 2,
                            direction="push")}
        if shape in FUSED_SHAPES_2D:
            # the wave marks, fused and through the seam (pull-only)
            fs = rt.GraphSession(g, max_batch=3,
                                 options=opts(shape, w=256, order=False))
            out[("fused", shape)] = {
                d: fused_and_seam(fs._problem, d, q) for d in ("auto", "pull")}
        # an edge update on the 2-D session: always a rebuild
        report = sess.update_edges(inserts=UPDATE_2D)
        out[("update", shape)] = {
            "report": dataclasses.asdict(report),
            "levels_batch": sess.levels_batch(q),
            "levels": sess.levels(q[2])}
    if rank < 4:
        g = gen.rmat(6, 4, seed=23)
        out["weighted_prepare"] = _raises(
            rt.GraphSession, g, options=opts((2, 2), weights=dyadic(
                np.random.default_rng(24), g.m)))
    if rank < 2:
        # tests/test_faults.py's stalled butterfly stage, on a (2, 1) mesh
        out["stall_stage"] = _faulted(
            rt, gen.rmat(7, 8, seed=2), opts((2, 1)),
            rt.FaultPlan(stall_butterfly_stage=0))
    return out


# ---------------------------------------------------------------------------
# model mesh program (tests/test_torch_model_mesh.py)
# ---------------------------------------------------------------------------
RING_SHAPES = ((32, 64), (64, 48))     # x (M, K), w (K, N)
PSUM_RANKS = 4
STEP_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "deepseek-v3-671b", "fm", "gin-tu")
RESTORE_RANKS = (2, 4)


def ring_operands():
    rng = np.random.default_rng(0)
    return (rng.normal(size=RING_SHAPES[0]).astype(np.float32),
            rng.normal(size=RING_SHAPES[1]).astype(np.float32))


def psum_operands():
    """Each rank's gradient (row r) and residual of ``compressed_psum``."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(PSUM_RANKS, 64)).astype(np.float32)
    r = (rng.normal(size=(PSUM_RANKS, 64)) * 0.01).astype(np.float32)
    return g, r


def gpipe_operands():
    rng = np.random.default_rng(0)
    return ((rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32),
            rng.normal(size=(8, 16)).astype(np.float32))


def step_setup(arch_id: str):
    """(model, loss_fn(params, batch), batch of numpy arrays, batch
    placements by key as spec tuples) of the sharded-step case: the
    arch's smoke model in float32, drawn from seed 0 on the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.families import gnn_init, gnn_single_loss
    from repro_torch.models import fm as FM
    from repro_torch.models import transformer as T
    arch = get_arch(arch_id)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    if arch.family == "lm":
        cfg = arch.smoke_cfg
        model = T.init_lm(cfg, gen, device="cpu")
        moe = cfg.is_moe
        tokens = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int64)

        def loss_fn(p, b):
            return T.lm_loss(T.bind(model, p), b,
                             compute_dtype=torch.float32, remat=True,
                             moe_groups=2 if moe else 1,
                             moe_spec=(("data",), "model") if moe else None)
        return model, loss_fn, tokens, ("data", None)
    if arch.family == "recsys":
        cfg = arch.smoke_cfg
        model = FM.init_fm(cfg, gen, device="cpu")
        batch = {"ids": rng.integers(0, cfg.rows_per_field,
                                     (8, cfg.n_fields)).astype(np.int32),
                 "labels": rng.integers(0, 2, 8).astype(np.float32)}

        def loss_fn(p, b):
            return FM.fm_loss(T.bind(model, p), cfg, b["ids"], b["labels"])
        return model, loss_fn, batch, {"ids": ("data", None),
                                       "labels": ("data",)}
    arch = dataclasses.replace(arch, model_cfg=arch.smoke_cfg)
    model = gnn_init(arch, gen, device="cpu")
    n, e = 24, 64
    cfg = arch.smoke_cfg
    batch = {"node_feat": rng.normal(size=(n + 1, cfg.d_in)).astype(
                 np.float32),
             "senders": rng.integers(0, n, e).astype(np.int32),
             "receivers": rng.integers(0, n, e).astype(np.int32),
             "labels": rng.integers(0, cfg.n_classes, n + 1).astype(
                 np.int32),
             "train_mask": rng.random(n + 1) < 0.5}
    batch["node_feat"][n] = 0
    loss1 = gnn_single_loss(arch, remat=True)

    def loss_fn(p, b):
        return loss1(T.bind(model, p), b)
    edges = (("data", "model"),)
    return model, loss_fn, batch, {"node_feat": (), "labels": (),
                                   "train_mask": (), "senders": edges,
                                   "receivers": edges}


def _step(loss_fn, leaves, batch):
    """One step of SGD with momentum at a learning rate of 0.1: an
    updated leaf differs from the single-device one by 0.1 times the
    gradients' difference (AdamW's first steps move every entry by
    about ±lr whatever its gradient, so a rounding-level difference of
    a near-zero gradient entry would flip a whole lr)."""
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)
    tcfg = TrainConfig(optimizer="sgd", peak_lr=0.1, warmup=0)
    return make_train_step(loss_fn, tcfg)(init_train_state(leaves, tcfg),
                                          batch)


def sharded_step_case(arch_id: str, mesh) -> dict:
    """The port's step on the arch's smoke model, single-device and on
    DTensor leaves over ``mesh``: the losses and the largest difference
    of each updated leaf, over that leaf's largest |value|."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.configs.families import gnn_axes
    from repro_torch.distributed.sharding import (Sharding, shard_tensor,
                                                  tree_shardings)
    from repro_torch.models import fm as FM
    from repro_torch.models import transformer as T
    arch = get_arch(arch_id)
    model, loss_fn, batch, bspec = step_setup(arch_id)
    leaves = T.reference_leaves(model)
    if arch.family == "lm":
        axes = T.lm_axes(arch.smoke_cfg)
    elif arch.family == "recsys":
        axes = FM.fm_axes(arch.smoke_cfg)
    else:
        import dataclasses
        axes = gnn_axes(dataclasses.replace(arch, model_cfg=arch.smoke_cfg))
    plain_b = torch.from_numpy(batch) if isinstance(batch, np.ndarray) \
        else {k: torch.from_numpy(v) for k, v in batch.items()}
    plain_state, plain_m = _step(loss_fn, leaves, plain_b)
    shard = tree_shardings(axes, leaves, arch.param_rules, mesh)
    d_leaves = {k: shard_tensor(v, shard[k]) for k, v in leaves.items()}
    if isinstance(plain_b, dict):
        d_batch = {k: shard_tensor(v, Sharding(mesh, bspec[k]))
                   for k, v in plain_b.items()}
    else:
        d_batch = shard_tensor(plain_b, Sharding(mesh, bspec))
    T.set_act_spec(Sharding(mesh, (("data",), None, None))
                   if arch.family == "lm" else None)
    try:
        with implicit_replication():
            state, metrics = _step(loss_fn, d_leaves, d_batch)
            loss = metrics["loss"]
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                         else loss)
            got = {k: v.full_tensor() for k, v in state.params.items()}
    finally:
        T.set_act_spec(None)
    rel = {k: float((got[k] - plain_state.params[k]).abs().max()
                    / plain_state.params[k].abs().max().clamp(min=1e-30))
           for k in got}
    specs = {k: shard[k].spec for k in shard}
    return {"loss": loss, "plain_loss": float(plain_m["loss"]),
            "rel": rel, "specs": specs}


def restore_tree():
    """The saved tree of the resharded restore: the qwen3 smoke model's
    leaves, one of them in bfloat16."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("qwen3-0.6b").smoke_cfg
    leaves = T.reference_leaves(T.init_lm(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    leaves["final_norm"] = (leaves["final_norm"] + 0.5).to(torch.bfloat16)
    return leaves


def program_model_mesh(rank: int, world: int) -> dict:
    """The model-mesh cases: the ring matmul on 8 ranks, compressed_psum
    on 4, GPipe on a (4, 2) mesh, the sharded steps on (2, 2) and the
    resharded restore on 2 and 4 ranks."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import comm_ledger
    from repro_torch.distributed.collectives import make_overlap_matmul
    from repro_torch.distributed.pipeline import bubble_fraction, make_gpipe
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.ft.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.compression import compressed_psum
    out: dict = {}

    def mesh_of(shape, names):
        return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
            shape), mesh_dim_names=names)

    # ring all-gather matmul over 8 ranks
    ring = mesh_of((world,), ("model",))
    x, w = ring_operands()
    kb, nb = x.shape[1] // world, w.shape[1] // world
    with comm_ledger() as events:
        y = make_overlap_matmul(ring, "model")(
            torch.from_numpy(x[:, rank * kb:(rank + 1) * kb]),
            torch.from_numpy(w[:, rank * nb:(rank + 1) * nb]))
    out["ring"] = y.numpy()
    out["ring_ledger"] = events

    # compressed_psum over the first 4 ranks
    psum = mesh_of((PSUM_RANKS,), ("data",))
    if rank < PSUM_RANKS:
        g, r = psum_operands()
        mean, new_res = compressed_psum(
            {"g": torch.from_numpy(g[rank])},
            {"g": torch.from_numpy(r[rank])}, psum, ("data",))
        out["psum"] = (mean["g"].numpy(), new_res["g"].numpy())

    # GPipe over the "pod" axis of a (4, 2) mesh
    pipe = mesh_of((4, 2), ("pod", "data"))
    ws, xp = gpipe_operands()
    stage = pipe.get_local_rank("pod")
    run = make_gpipe(pipe, lambda p, v: torch.tanh(v @ p), n_micro=4,
                     axis="pod")
    out["gpipe"] = run(torch.from_numpy(ws[stage]),
                       torch.from_numpy(xp)).numpy()
    out["bubble"] = bubble_fraction(4, 4)

    # the sharded steps on a (2, 2) mesh
    grid = make_test_mesh(2, 2)
    if rank < 4:
        out["steps"] = {a: sharded_step_case(a, grid) for a in STEP_ARCHS}

    # save at world size 1, restore on 2 and 4 ranks
    path = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(path, src=0)
    tree = restore_tree()
    if rank == 0:
        save_checkpoint(path[0], 7, tree)
    dist.barrier()
    from repro_torch.configs import get_arch
    arch = get_arch("qwen3-0.6b")
    for P in RESTORE_RANKS:
        mesh = mesh_of((P // 2, 2), ("data", "model")) if P == 4 else \
            mesh_of((1, P), ("data", "model"))
        if rank >= P:
            continue
        rules = dict(arch.param_rules, embed="data")
        shard = tree_shardings(T.lm_axes(arch.smoke_cfg), tree, rules, mesh)
        got, manifest = restore_checkpoint(
            os.path.join(path[0], "step_0000000007"), tree,
            shardings=shard)
        out[("restore", P)] = {
            "coord": list(mesh.get_coordinate()),
            "specs": {k: shard[k].spec for k in shard},
            "blocks": {k: v.to_local().float().numpy()
                       if v.dtype == torch.bfloat16 else v.to_local().numpy()
                       for k, v in got.items()},
            "dtypes": {k: str(v.dtype) for k, v in got.items()},
            "step": manifest["step"]}
    dist.barrier()
    return out
