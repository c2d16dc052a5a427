"""Kernel bench of the port, after ``benchmarks/kernel_bench.py``::

    PYTHONPATH=src python -m repro_torch.bench.kernel_bench

Rows (``name,us_per_call,derived``): the single-source pull ``bvss_pull``
(B = 4,096 VSSs), the dense ``bit_spmm`` at the reference bench's shape
(R = C = 512, S = 128), and the end-of-level sweeps side by side: the unit
``finalize_sweep`` beside the fused lazy ``finalize_pack_sweep`` it is the
baseline of.  Each kernel row has its twin's row after it, and each kernel
is first held equal to its twin.  On the card a call's time is the host
clock around one launch and a synchronise (launch cost included); the
kernels' device times at the main-path shapes come from ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bench.common import fmt_row
from repro_torch.core.bvss import resolve_device
from repro_torch.errors import KernelFaultError
from repro_torch.kernels import (bit_spmm, bvss_pull, finalize_pack_sweep,
                                 finalize_sweep)
from repro_torch.kernels.ref import (INF32, bit_spmm_ref, bvss_pull_ref,
                                     finalize_pack_ref, finalize_sweep_ref)


def _med_time(f, *args, reps: int = 5) -> float:
    """Median seconds of one call (after a warm call), synchronised."""
    def call():
        f(*args)
        if args[0].is_cuda:
            torch.cuda.synchronize()
    call()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _same(name: str, got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise KernelFaultError(f"kernel_bench: {name} differs from its twin")


def run(device=None, n_vertices: int = 1 << 22, verbose: bool = True
        ) -> list[str]:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    tag = device.type

    def words(shape):
        w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(device)

    rows = []
    B, sigma = 4096, 8
    masks, fb = words((B, 32)), words((B,))
    _same("bvss_pull", bvss_pull(masks, fb, sigma=sigma),
          bvss_pull_ref(masks, fb, sigma))
    sec = _med_time(lambda m, f: bvss_pull(m, f, sigma=sigma), masks, fb)
    rows.append(fmt_row(f"kernel/bvss_pull[{tag}]", sec * 1e6,
                        f"slices={B * 128};calls_per_128_slices="
                        f"2(paper)_vs_16(brs)"))
    sec = _med_time(lambda m, f: bvss_pull_ref(m, f, sigma), masks, fb)
    rows.append(fmt_row("kernel/bvss_pull[twin]", sec * 1e6, ""))

    R, C, S = 512, 512, 128
    a = words((R, C // 32))
    x = torch.from_numpy(rng.integers(0, 2, (C, S)).astype(np.int8)).to(
        device)
    _same("bit_spmm", bit_spmm(a, x), bit_spmm_ref(a, x))
    sec = _med_time(bit_spmm, a, x)
    rows.append(fmt_row(f"kernel/bit_spmm[{tag}]", sec * 1e6,
                        f"R={R};C={C};sources={S};"
                        f"paper_m8n8k128_dots=64"))
    sec = _med_time(bit_spmm_ref, a, x)
    rows.append(fmt_row("kernel/bit_spmm[twin]", sec * 1e6, ""))

    N, lvl = n_vertices, 7
    levels = torch.from_numpy(rng.choice(
        np.array([INF32, lvl - 1, 3], np.int32), N, p=[0.6, 0.1, 0.3])).to(
        device)
    marks = torch.from_numpy(rng.integers(0, 2, N).astype(np.uint8)).to(
        device)
    n_sets, n_fwords = -(-N // sigma), -(-N // 32)
    kw = dict(sigma=sigma, n_fwords=n_fwords, n_sets=n_sets, marks=marks)
    _same("finalize_sweep", finalize_sweep(marks, levels, lvl),
          finalize_sweep_ref(marks, levels, lvl))
    _same("finalize_pack_sweep", finalize_pack_sweep(levels, lvl, **kw),
          finalize_pack_ref(levels, lvl, **kw))
    for name, f, args in (
            (f"finalize_sweep[{tag}]", finalize_sweep, (marks, levels, lvl)),
            ("finalize_sweep[twin]", finalize_sweep_ref,
             (marks, levels, lvl)),
            (f"finalize_pack_sweep_lazy[{tag}]",
             lambda lv: finalize_pack_sweep(lv, lvl, **kw), (levels,)),
            ("finalize_pack_sweep_lazy[twin]",
             lambda lv: finalize_pack_ref(lv, lvl, **kw), (levels,))):
        rows.append(fmt_row(f"kernel/{name}", _med_time(f, *args) * 1e6,
                            f"N={N}"))
    if verbose:
        for r in rows:
            print(r)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
