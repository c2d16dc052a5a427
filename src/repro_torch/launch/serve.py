"""Serving launcher: continuous-batching generation with a smoke-config LM,
the port of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 16 --max-new 12 [--device cpu]

The model is initialised from ``--seed`` (no weights are fetched) and runs
in float32 on the CUDA card unless ``--device cpu`` asks for the CPU;
without a card the default raises
:class:`~repro_torch.errors.ConfigError`.  The LM tier
(``Request``/``ServeEngine``) stays OUTSIDE the graph façade contract
(``import repro_torch``; ``tests/api_surface.txt``), as in the reference:
this launcher reaches into ``repro_torch.serve`` for it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.bvss import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    assert arch.family == "lm", "serving applies to LM archs"
    cfg = arch.smoke_cfg
    model = T.init_lm(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    eng = ServeEngine(model, cfg, max_batch=args.max_batch,
                      max_len=args.prompt_len + args.max_new + 8,
                      prompt_len=args.prompt_len)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        rng.integers(4, args.prompt_len + 1)),
                    max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.time()
    outs = eng.run(reqs)
    dt = time.time() - t0
    new_tokens = sum(len(o.tokens) for o in outs) - sum(
        min(len(r.prompt), args.prompt_len) for r in reqs)
    print(f"[serve] arch={arch.id}(smoke) served {len(outs)} requests, "
          f"{new_tokens} new tokens in {dt:.2f}s "
          f"({new_tokens / dt:.1f} tok/s, continuous batching over "
          f"{args.max_batch} slots)")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: ...{[int(t) for t in o.tokens[-8:]]}")
    return outs


if __name__ == "__main__":
    main()
