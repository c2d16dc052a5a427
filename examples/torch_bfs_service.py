"""End-to-end driver on the PyTorch port: a graph-analytics service
answering batched BFS and centrality queries with the full BLEST pipeline
(the counterpart of ``examples/bfs_service.py``).

Everything comes through the ``repro_torch`` façade: a multi-tenant
:class:`repro_torch.GraphSessionManager`, the async
:class:`repro_torch.RequestQueue` (non-blocking submits that coalesce into
shared multi-source waves), and streaming edge updates via
:meth:`GraphSessionManager.update_edges`.  The session runs on the CUDA
card; ``--device cpu`` runs it on the CPU through the kernels' PyTorch
twins.

    PYTHONPATH=src python examples/torch_bfs_service.py [--device cpu]
"""
import argparse
import time

import numpy as np

import repro_torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = ap.parse_args(argv).device

    from repro_torch.graphs import generators as gen
    g = gen.rmat(10, 10, seed=3)

    mgr = repro_torch.GraphSessionManager()
    sess = mgr.open_session("social", g, max_batch=4,
                            options=repro_torch.PrepareOptions(
                                w=512, seed=0, device=device))
    print(f"service up: n={g.n} m={g.m} ordering={sess.ordering} "
          f"compression={sess.bvss.compression_ratio():.3f} "
          f"preprocess={sess.preprocess_s:.2f}s")

    rng = np.random.default_rng(0)
    queries = [int(q) for q in rng.integers(0, g.n, 12)]
    sess.levels(queries[0])           # warm the single-source path
    sess.levels_batch(queries[:2])    # warm the wave path

    t0 = time.time()
    seq = [sess.levels(q) for q in queries]
    t_seq = time.time() - t0

    # async path: submit returns a future immediately; drain() coalesces
    # the backlog into max_batch-wide waves, refilling slots mid-flight
    queue = repro_torch.RequestQueue(mgr)
    t0 = time.time()
    futs = [queue.submit("social", q) for q in queries]
    queue.drain()
    lvs = [f.result(0) for f in futs]
    t_queue = time.time() - t0

    from repro_torch.core import reference_bfs
    for q, lv_s, lv in zip(queries, seq, lvs):
        ref = reference_bfs(g, q)
        assert (lv_s == ref).all(), f"query {q} mismatch"
        assert (lv == ref).all(), f"queued query {q} mismatch"
    qs = queue.stats()
    print(f"served {len(queries)} level queries: sequential {t_seq:.2f}s, "
          f"queued {t_queue:.2f}s over {qs['waves']} waves "
          f"({qs['coalesced']} coalesced mid-flight, "
          f"{t_seq / max(t_queue, 1e-9):.2f}x, all verified)")

    t0 = time.time()
    srcs, cc = sess.closeness_sample(8, seed=0)
    print(f"closeness-centrality sample (8 sources, BVSS bit-SpMM waves): "
          f"{time.time() - t0:.2f}s, sources={srcs.tolist()}, "
          f"mean={cc.mean():.4f}")

    # streaming maintenance: patch a handful of edges into the prepared
    # BVSS — no full re-prepare, epoch bumps, session keeps serving
    wrng = np.random.default_rng(1)
    new_edges = sorted({(int(a), int(b)) for a, b in
                        wrng.integers(0, g.n, (4, 2)) if a != b})
    report = mgr.update_edges("social", inserts=new_edges)
    if report is not None:
        print(f"edge update: path={report.path} epoch={report.epoch} "
              f"+{report.n_inserted} edges "
              f"({report.vss_rows_rewritten} VSS rows rewritten)")
        a, b = new_edges[0]
        lv = sess.levels(a)
        print(f"post-update query from {a}: new edge ({a}, {b}) live "
              f"(level[{b}]={int(lv[b])}), reached "
              f"{(lv < np.iinfo(np.int32).max).sum()}/{g.n}")


if __name__ == "__main__":
    main()
