"""Quickstart on the PyTorch port: the BLEST pipeline end to end on a
synthetic scale-free graph, through ``repro_torch`` (the counterpart of
``examples/quickstart.py``).

The first half uses only the ``repro_torch`` façade — prepare once, query
many times, stream edge updates.  The second half drops to the deep
modules to race every engine variant (internals, not part of the façade
contract).  The engines run on the CUDA card; ``--device cpu`` runs them
on the CPU through the kernels' PyTorch twins.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
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
    g = gen.rmat(11, 12, seed=7)

    # the ONE static pipeline: classify, order, build BVSS, pick engine
    prep = repro_torch.prepare(g, options=repro_torch.PrepareOptions(
        w=512, seed=7, device=device))
    print(f"graph: n={g.n} m={g.m}  ordering={prep.ordering} "
          f"engine={prep.engine_name} "
          f"compression={prep.bvss.compression_ratio():.3f}")

    src = 0
    lv = prep.levels(src)
    print(f"BFS from {src}: "
          f"{int((lv != np.iinfo(np.int32).max).sum())} reachable")

    # streaming maintenance: patch edges into the prepared BVSS; the
    # epoch bumps and the new value keeps answering queries
    prep2 = repro_torch.apply_edge_updates(prep, inserts=[(src, g.n - 1)])
    print(f"after insert ({src}, {g.n - 1}): path={prep2.last_update.path} "
          f"epoch={prep2.epoch} level[{g.n - 1}]="
          f"{int(prep2.levels(src)[g.n - 1])}")

    # --- internals below: race the engine variants head to head --------
    import torch

    from repro_torch.core import (ENGINES, build_bvss, make_engine,
                                  reference_bfs)
    from repro_torch.core.ordering import auto_order, social_like_report

    rep = social_like_report(g)
    print(f"social-like={rep.is_social}")
    perm, kind = auto_order(g, w=512)
    g_ord = g.permute_fast(perm)
    for name, gg in [("natural", g), (kind, g_ord)]:
        b = build_bvss(gg)
        print(f"  {name:16s} compression={b.compression_ratio():.3f} "
              f"update_divergence={b.update_divergence():8.1f}")

    ref = reference_bfs(g_ord, src)
    for engine in ENGINES:
        if engine == "dense_pull" and g.n > 4096:
            continue
        fn = make_engine(g_ord, engine, device=device)
        fn(src)  # warm: kernel build, allocator
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        lv = fn(src).cpu().numpy()      # ends in a device-to-host copy
        dt = (time.time() - t0) * 1e3
        ok = "OK " if (lv == ref).all() else "FAIL"
        print(f"  {engine:12s} {dt:8.2f} ms  {ok}")


if __name__ == "__main__":
    main()
