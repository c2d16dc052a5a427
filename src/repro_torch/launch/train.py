"""Training launcher, the port of ``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 50 --ckpt-dir /tmp/ckpt [--device cpu]

It runs an arch's smoke config (``--smoke`` is on and, as in the
reference, cannot be turned off; the full widths run through
:func:`repro_torch.train.train` directly) with the whole substrate: the
deterministic data (the token pipeline for an LM; for a GNN one
full-graph batch of ``rmat(9)`` for GIN and molecule batches of
``--batch`` graphs, made anew each step, for EGNN, NequIP and DimeNet;
Criteo-like batches for FM), AdamW, checkpoint/restart, the
straggler-tolerant prefetch and, with ``--fail-at``, an injected failure
(the chaos drill).  The model is initialised from ``--seed`` (no weights
are fetched) and trains in float32 on the CUDA card unless ``--device
cpu`` asks for the CPU; without a card the default raises
:class:`~repro_torch.errors.ConfigError`.

As in the reference, a molecule batch's graph ids run 0 .. B-1 while the
smoke configs read ``n_graphs = 1`` energies: the loss compares graph
0's energy with every graph's target (PERF.md §7).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.base import get_arch
from repro_torch.configs.families import gnn_init, gnn_single_loss
from repro_torch.core.bvss import resolve_device
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.data.graphs import (full_graph_batch, molecule_batch,
                                     recsys_batch)
from repro_torch.ft.manager import FailureInjector, RestartManager
from repro_torch.graphs import generators as gen
from repro_torch.models import fm as FM
from repro_torch.models import transformer as T
from repro_torch.models.gnn import one_hot
from repro_torch.train import TrainConfig, train


def lm_setup(cfg, args, device):
    """(params in the reference's layout, loss_fn, batch_fn)."""
    model = T.init_lm(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch,
        seed=args.seed))

    def loss_fn(params, batch):
        tokens = torch.from_numpy(batch).long().to(device)
        return T.lm_loss(T.bind(model, params), tokens,
                         compute_dtype=torch.float32, remat=False)

    return T.reference_leaves(model), loss_fn, pipe.batch


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def gnn_setup(arch, cfg, args, device):
    """(params in the reference's layout, loss_fn, batch_fn) of a GNN
    arch: GIN on one full-graph batch, the others on molecule batches
    made anew each step (deterministic in the step)."""
    arch = dataclasses.replace(arch, model_cfg=cfg)
    model = gnn_init(arch, torch.Generator(device=device).manual_seed(
        args.seed), device)
    loss1 = gnn_single_loss(arch, remat=False)

    def loss_fn(params, batch):
        return loss1(T.bind(model, params), batch)

    if arch.gnn_kind == "gin":
        g = gen.rmat(9, 8, seed=args.seed)
        fb = full_graph_batch(g, cfg.d_in, cfg.n_classes, seed=args.seed)
        batch = _tensors(dataclasses.asdict(fb), device)
        return T.reference_leaves(model), loss_fn, lambda step: batch

    def batch_fn(step):
        mb = molecule_batch(args.batch, 12, 32,
                            n_species=getattr(cfg, "n_species", 8),
                            seed=args.seed * 100_003 + step)
        b = _tensors({"species": mb.species, "pos": mb.pos,
                      "senders": mb.senders, "receivers": mb.receivers,
                      "graph_ids": mb.graph_ids, "targets": mb.targets},
                     device)
        if arch.gnn_kind == "dimenet":
            b.update(_tensors({"t_kj": mb.t_kj, "t_ji": mb.t_ji}, device))
        if arch.gnn_kind == "egnn":
            b["node_feat"] = one_hot(b.pop("species") % cfg.d_in, cfg.d_in)
        return b

    return T.reference_leaves(model), loss_fn, batch_fn


def rec_setup(cfg, args, device):
    """(params in the reference's layout, loss_fn, batch_fn) of FM on
    Criteo-like batches of ``--batch`` examples."""
    model = FM.init_fm(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)

    def batch_fn(step):
        ids, labels = recsys_batch(args.batch, cfg.n_fields,
                                   cfg.rows_per_field,
                                   seed=args.seed * 7 + step)
        return _tensors({"ids": ids, "labels": labels}, device)

    def loss_fn(params, batch):
        return FM.fm_loss(T.bind(model, params), cfg, batch["ids"],
                          batch["labels"])

    return T.reference_leaves(model), loss_fn, batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (chaos drill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.smoke_cfg if args.smoke else arch.model_cfg
    if arch.family == "lm":
        params, loss_fn, batch_fn = lm_setup(cfg, args, device)
    elif arch.family == "gnn":
        params, loss_fn, batch_fn = gnn_setup(arch, cfg, args, device)
    else:
        params, loss_fn, batch_fn = rec_setup(cfg, args, device)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] arch={arch.id} family={arch.family} params={n_params:,}")

    tcfg = TrainConfig(steps=args.steps, peak_lr=args.lr,
                       warmup=max(2, args.steps // 20),
                       log_every=max(1, args.steps // 10),
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    injector = (FailureInjector((args.fail_at,))
                if args.fail_at >= 0 else None)

    def body(resume):
        return train(loss_fn, params, batch_fn, tcfg, injector=injector)

    if injector is not None:
        mgr = RestartManager(max_restarts=3)
        result = mgr.run(body)
        print(f"[train] survived {mgr.stats.restarts} injected failure(s)")
    else:
        result = body(0)
    first, last = result.losses[0][1], result.losses[-1][1]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"(straggler timeouts: {result.straggler_timeouts})")
    return result


if __name__ == "__main__":
    main()
