"""Roofline variants of one dry-run cell, the port of
``benchmarks/perf_iter.py``: trace a cell with config overrides and
print the roofline delta against the baseline artifact of
:mod:`repro_torch.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.bench.perf_iter \\
        --cell qwen3-0.6b/train_4k --variant mp_attn

Estimates from spec-sheet constants, as the dry run's; the hypotheses
beside each variant are the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

_PURE_DP_RULES = {"embed": None, "heads": None, "kv_heads": None,
                  "head_dim": None, "ffn": None, "vocab": None,
                  "layers": None}

VARIANTS = {
    # H: fp32 q/k/v copies + fp32 probabilities dominate attention HBM
    # traffic -> bf16 matmuls with fp32 accumulation halve those bytes.
    "mp_attn": dict(model=dict(mp_attn=True)),
    # H: fp32 params => fp32 grads => fp32 DP all-reduce; bf16 params with
    # fp32 math in the optimizer halve grad bytes and param memory.
    "bf16_params": dict(arch=dict(param_dtype="bfloat16",
                                  moment_dtype="bfloat16")),
    "mp_attn+bf16": dict(model=dict(mp_attn=True),
                         arch=dict(param_dtype="bfloat16",
                                   moment_dtype="bfloat16")),
    # H: more microbatches shrink MoE dispatch buffers but repeat per-pass
    # collectives; fewer do the reverse.
    "accum2": dict(arch=dict(accum_steps=2)),
    "accum8": dict(arch=dict(accum_steps=8)),
    # H: TP=16 is mis-sized for sub-1B models; pure 256-way DP removes
    # the TP collectives, leaving the gradient all-reduce.
    "pure_dp": dict(arch=dict(param_rules=_PURE_DP_RULES,
                              lm_batch_axes="ALL")),
    "pure_dp+bf16": dict(arch=dict(param_rules=_PURE_DP_RULES,
                                   lm_batch_axes="ALL",
                                   param_dtype="bfloat16",
                                   moment_dtype="bfloat16")),
    # H(fm): the dense DP all-reduce of the table gradient wastes most of
    # its bytes; sharding the table over (data, model) keeps grads local.
    "full_shard_table": dict(arch=dict(
        param_rules={"table_rows": ("data", "model")})),
    # H: casting the local partial grads to bf16 halves the reduce bytes.
    "bf16_grads": dict(arch=dict(grad_dtype="bfloat16")),
}


def run_variant(cell: str, variant: str, mesh: str = "single",
                out_dir: str = "artifacts/perf_torch",
                base_dir: str = "artifacts/dryrun_torch") -> dict:
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.dryrun import run_cell
    arch_id, shape = cell.split("/")
    spec = VARIANTS[variant]
    arch = get_arch(arch_id)
    if "model" in spec:
        arch = dataclasses.replace(
            arch, model_cfg=dataclasses.replace(arch.model_cfg,
                                                **spec["model"]))
    if "arch" in spec:
        arch = dataclasses.replace(arch, **spec["arch"])
    rec = run_cell(arch_id, shape, mesh,
                   out_dir=os.path.join(out_dir, variant), arch_obj=arch)
    base_path = os.path.join(base_dir, mesh, f"{arch_id}__{shape}.json")
    if os.path.exists(base_path) and rec["status"] == "ok":
        with open(base_path) as f:
            base = json.load(f)
        if base["status"] == "ok":
            print(f"--- {cell} [{variant}] vs baseline ---")
            for k in ("compute_s", "memory_s", "collective_s"):
                b, v = base["roofline"][k], rec["roofline"][k]
                print(f"  {k:14s} {b:.3e} -> {v:.3e} "
                      f"({(1 - v / max(b, 1e-30)) * 100:+.1f}% better)"
                      .replace("+-", "-"))
            mb = base["memory"]["total_bytes_per_device"] / 1e9
            mv = rec["memory"]["total_bytes_per_device"] / 1e9
            print(f"  {'mem/device':14s} {mb:.2f} GB -> {mv:.2f} GB")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rec = run_variant(args.cell, args.variant, args.mesh)
    return 0 if rec["status"] != "error" else 1


if __name__ == "__main__":
    raise SystemExit(main())
