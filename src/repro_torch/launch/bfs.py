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

The engines run on the CUDA card unless ``--device cpu`` asks for the CPU
(the kernels' PyTorch twins).  The reference's ``--service`` mode and its
``--max-batch``, ``--queue``, ``--deadline-s`` and ``--verify-fraction``
knobs need the robust serving tier, and ``--devices N > 1`` the mesh: each
raises :class:`~repro_torch.errors.ConfigError` naming its slice.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import PrepareOptions, prepare
from repro_torch.core import reference_bfs
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

#: the reference's flags that wait for a later slice: flag -> (default,
#: the slice that brings it)
_UNPORTED = {
    "service": (False, "the robust serving tier (GraphSessionManager, "
                       "ROADMAP.md queue 1 item 7)"),
    "max_batch": (4, "--service, with the robust serving tier (ROADMAP.md "
                     "queue 1 item 7)"),
    "queue": (False, "the async RequestQueue (ROADMAP.md queue 1 item 7)"),
    "deadline_s": (None, "the robust serving tier's deadlines (ROADMAP.md "
                         "queue 1 item 7)"),
    "verify_fraction": (0.0, "the robust serving tier's verify mode "
                             "(ROADMAP.md queue 1 item 7)"),
    "devices": (1, "the mesh slice (ROADMAP.md queue 1 item 11)"),
}


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
                    help="not ported yet: raises ConfigError")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="not ported yet (--service): raises ConfigError")
    ap.add_argument("--queue", action="store_true",
                    help="not ported yet: raises ConfigError")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="not ported yet: raises ConfigError")
    ap.add_argument("--verify-fraction", type=float, default=0.0,
                    help="not ported yet: raises ConfigError")
    ap.add_argument("--devices", type=int, default=1,
                    help="more than 1 is not ported yet: raises "
                         "ConfigError")
    args = ap.parse_args(argv)
    for flag, (default, slice_) in _UNPORTED.items():
        if getattr(args, flag) != default:
            raise ConfigError(
                f"--{flag.replace('_', '-')} is not ported to PyTorch yet: "
                f"it comes with {slice_}")

    g = build_graph(args.graph, args.scale, args.seed)
    rep = social_like_report(g)
    print(f"[bfs] graph={args.graph} n={g.n} m={g.m} "
          f"social_like={rep.is_social} (top1={rep.top1_share:.2f} "
          f"slope={rep.ll_slope:.2f}) device={args.device}")

    variant = ENGINE_VARIANTS[args.engine]
    t0 = time.time()
    prep = prepare(g, options=PrepareOptions(
        w=512, seed=args.seed, order=variant["order"],
        engine=variant["engine"], device=args.device))
    prep_s = time.time() - t0
    if variant["order"]:
        print(f"[bfs] ordering={prep.ordering} "
              f"(prepare={prep_s:.2f}s incl. BVSS+engine), "
              f"bandwidth={prep.graph.bandwidth()}")
    b = prep.bvss
    print(f"[bfs] BVSS: num_vss={b.num_vss} slices={b.num_slices} "
          f"compression={b.compression_ratio():.3f} "
          f"update_divergence={b.update_divergence():.0f} "
          f"memory={b.memory_bytes()['total'] / 1e6:.1f}MB")
    if variant["engine"] is None:
        print(f"[bfs] policy chose update scheme: {prep.engine_name}")

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
    print(f"[bfs] {args.engine}: {np.mean(times) * 1e3:.2f} ms/BFS "
          f"(median {np.median(times) * 1e3:.2f}) over {args.sources} "
          f"sources; last run reached {reached}/{g.n} vertices"
          + ("; VERIFIED vs oracle" if args.verify else ""))


if __name__ == "__main__":
    main()
