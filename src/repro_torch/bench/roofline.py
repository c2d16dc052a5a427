"""Roofline report of the port's dry run, the port of
``benchmarks/roofline.py``: reads ``artifacts/dryrun_torch/*/*.json``
(:mod:`repro_torch.launch.dryrun`) and renders the table of roofline
terms with the MODEL/traced FLOPs ratio.

    PYTHONPATH=src python -m repro_torch.bench.roofline [--dir artifacts/dryrun_torch]

The terms are estimates from spec-sheet constants
(:data:`repro_torch.launch.dryrun.PEAK_FLOPS_BF16`, ``HBM_BW``,
``LINK_BW``), not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os


def _lm_active_params(arch) -> float:
    """Active (per-token) non-embedding parameters for 6·N·D MODEL_FLOPS,
    counted from the model's ``meta`` leaves."""
    from repro_torch.models import transformer as T
    cfg = arch.model_cfg
    leaves = T.reference_leaves(T.init_lm(cfg, device="meta"))
    mc = cfg.moe
    total = 0.0
    for path, leaf in leaves.items():
        n = float(math.prod(leaf.shape))
        if "embed" in path and "blocks" not in path:
            continue  # embeddings excluded from 6ND
        # routed expert stacks are (L, E, d, f): only top_k/E active
        if mc is not None and "ffn" in path and "shared" not in path \
                and leaf.dim() >= 4 and leaf.shape[-3] == mc.n_experts:
            n *= mc.top_k / mc.n_experts
        total += n
    return total


def model_flops(arch, shape) -> float | None:
    if arch.family != "lm":
        return None
    n_active = _lm_active_params(arch)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token a slot


def load(dir_: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*", "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def render(recs: list[dict]) -> str:
    from repro_torch.configs.base import get_arch
    lines = [
        "| arch | shape | mesh | compute_s | memory_s | collective_s "
        "| dominant | mem/dev GB | MODEL/traced flops | source |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
        if r["status"] == "skipped":
            lines.append(f"{head} SKIP | | | | | {r['reason'][:50]} | |")
            continue
        if r["status"] != "ok":
            lines.append(f"{head} ERROR | | | | | "
                         f"{r.get('error', '')[:60]} | |")
            continue
        t = r["roofline"]
        mem = r["memory"].get("total_bytes_per_device", 0) / 1e9
        ratio = ""
        arch = get_arch(r["arch"])
        mf = model_flops(arch, arch.shapes[r["shape"]])
        traced = r["flops_per_device"] * math.prod(r["mesh_shape"])
        if mf and traced:
            ratio = f"{mf / traced:.2f}"
        lines.append(
            f"{head} {t['compute_s']:.2e} | {t['memory_s']:.2e} "
            f"| {t['collective_s']:.2e} | {r['dominant'].replace('_s', '')} "
            f"| {mem:.2f} | {ratio} | {r.get('cost_source', '')[:14]} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    print(render(load(args.dir)))


if __name__ == "__main__":
    main()
