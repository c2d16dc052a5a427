"""Training launcher, the LM half of ``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 50 --ckpt-dir /tmp/ckpt [--device cpu]

It runs an arch's smoke config (``--smoke`` is on and, as in the
reference, cannot be turned off; the full widths run through
:func:`repro_torch.train.train` directly) with the whole substrate: the
deterministic token pipeline, AdamW, checkpoint/restart, the
straggler-tolerant prefetch and, with ``--fail-at``, an injected failure
(the chaos drill).  The model is initialised from ``--seed`` (no weights
are fetched) and trains in float32 on the CUDA card unless ``--device
cpu`` asks for the CPU; without a card the default raises
:class:`~repro_torch.errors.ConfigError`.  The GNN and recsys families
are ROADMAP.md queue 1 item 13d.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.bvss import resolve_device
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.errors import ConfigError
from repro_torch.ft.manager import FailureInjector, RestartManager
from repro_torch.models import transformer as T
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
    if arch.family != "lm":
        raise ConfigError(
            f"training the {arch.family} family is not ported to PyTorch "
            f"yet (ROADMAP.md queue 1 item 13d)")
    cfg = arch.smoke_cfg if args.smoke else arch.model_cfg
    params, loss_fn, batch_fn = lm_setup(cfg, args, device)
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
