"""Train-step factory and host training loop with fault tolerance, the
port of ``repro/train/loop.py``.

:func:`make_train_step` builds ``step(state, batch) -> (state, metrics)``
from any ``loss_fn(params, batch)`` over a ``{path: tensor}`` params dict
(for an LM, :func:`repro_torch.models.transformer.bind` runs the model on
it), with gradient accumulation over ``accum_steps`` micro-batches (a
loop that sums the gradients in float32 and divides, where the reference
scans) and any optimizer of ``repro_torch.train.optim``.  It runs
eagerly, out of place: no ``jit`` and no donation of the state.  A
parameter that gets no gradient (the DeepSeek-V3 router's bias, which
steers the choice only) counts as a zero gradient, as under
``jax.grad``.  The gradients are computed with TF32 off, so a float32
model's backward pass (remat recomputation included) rounds as its
forward does.

:func:`train` wires in the substrate: the prefetch queue with straggler
mitigation, failure injection, asynchronous checkpoints and a
restart-safe resume from the newest complete checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.errors import ConfigError
from repro_torch.ft.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.ft.manager import FailureInjector, PrefetchQueue
from repro_torch.models.transformer import float32_matmuls
from repro_torch.train import optim


class TrainState(NamedTuple):
    params: dict
    opt_state: Any
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup: int = 10
    accum_steps: int = 1
    log_every: int = 10
    ckpt_every: int = 0          # 0 = disabled
    ckpt_dir: str = ""
    keep_ckpts: int = 3
    max_grad_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    grad_dtype: torch.dtype | None = None   # cast the gradients (bfloat16
                                            # halves a reduction's bytes)


def make_optimizer(tcfg: TrainConfig):
    name = tcfg.optimizer
    if name == "adamw":
        ocfg = optim.AdamWConfig(max_grad_norm=tcfg.max_grad_norm,
                                 moment_dtype=tcfg.moment_dtype)
    elif name == "sgd":
        ocfg = optim.SGDConfig(max_grad_norm=tcfg.max_grad_norm)
    elif name == "adafactor":
        ocfg = optim.AdafactorConfig(max_grad_norm=tcfg.max_grad_norm)
    else:
        raise ValueError(name)
    _, init_fn, update_fn = optim.OPTIMIZERS[name]
    lr_fn = optim.warmup_cosine(tcfg.peak_lr, tcfg.warmup, tcfg.steps)
    return ocfg, init_fn, update_fn, lr_fn


def init_train_state(params: dict, tcfg: TrainConfig) -> TrainState:
    """The step-0 state over a copy of ``params`` (a restart re-initialises
    from the caller's params, which training must not change)."""
    ocfg, init_fn, _, _ = make_optimizer(tcfg)
    params = {k: p.detach().clone() for k, p in params.items()}
    return TrainState(params=params, opt_state=init_fn(params, ocfg),
                      step=torch.zeros((), dtype=torch.int32))


def value_and_grad(loss_fn: Callable, params: dict, batch):
    """(the loss, detached; its gradient by leaf, zeros for a leaf the
    loss does not reach)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad(), float32_matmuls(torch.float32):
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def _micro(batch, n: int, i: int):
    """Micro-batch ``i`` of ``n``: rows ``[i · B/n, (i+1) · B/n)``.  A
    DTensor batch sharded on its rows takes rows ``[i · b/n, (i+1) · b/n)``
    of each rank's block of b rows, so that no rank gathers another's
    (every rank runs its own micro-batches, as under data parallelism)."""
    rows = batch.shape[0] // n
    if isinstance(batch, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in batch.placements):
        local = batch.to_local()
        if local.shape[0] % n:
            raise ConfigError(
                f"{local.shape[0]} rows a rank do not split into {n} "
                f"micro-batches")
        b = local.shape[0] // n
        shape = (rows, *batch.shape[1:])
        return DTensor.from_local(
            local[i * b:(i + 1) * b], batch.device_mesh, batch.placements,
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    return batch[i * rows:(i + 1) * rows]


def make_train_step(loss_fn: Callable, tcfg: TrainConfig) -> Callable:
    ocfg, _, update_fn, lr_fn = make_optimizer(tcfg)

    def step(state: TrainState, batch):
        if tcfg.accum_steps > 1:
            n = tcfg.accum_steps
            losses = []
            grads = None
            for i in range(n):
                mloss, mgrads = value_and_grad(loss_fn, state.params,
                                               _micro(batch, n, i))
                losses.append(mloss)
                # float32 sums, the first micro-batch's gradient their start
                # (0 + g is g: one add fewer, and on DTensor leaves every
                # add meets the same layouts)
                grads = {k: g.float() for k, g in mgrads.items()} \
                    if grads is None else \
                    {k: g + mgrads[k] for k, g in grads.items()}
            loss = sum(losses) / n
            grads = {k: g / n for k, g in grads.items()}
        else:
            loss, grads = value_and_grad(loss_fn, state.params, batch)
        if tcfg.grad_dtype is not None:
            grads = {k: g.to(tcfg.grad_dtype) for k, g in grads.items()}
        lr = lr_fn(state.step)
        params, opt_state, gnorm = update_fn(grads, state.opt_state,
                                             state.params, ocfg, lr)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step


@dataclasses.dataclass
class RunResult:
    final_state: TrainState
    losses: list
    straggler_timeouts: int = 0


def train(loss_fn: Callable, init_params: dict,
          batch_fn: Callable[[int], Any], tcfg: TrainConfig, *,
          injector: FailureInjector | None = None,
          prefetch_timeout_s: float = 30.0,
          log_fn: Callable[[str], None] = print) -> RunResult:
    """Host training loop; resumes from ``tcfg.ckpt_dir`` if checkpoints
    exist.  ``batch_fn(step)`` must be deterministic in ``step`` (restart
    safety); it doubles as the straggler backup batch source."""
    step_fn = make_train_step(loss_fn, tcfg)
    state = init_train_state(init_params, tcfg)
    start = 0
    ckpt = None
    if tcfg.ckpt_every and tcfg.ckpt_dir:
        ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        restored = restore_latest(tcfg.ckpt_dir, state)
        if restored is not None:
            state, manifest = restored
            start = int(manifest["step"])
            log_fn(f"[train] resumed from step {start}")

    q = PrefetchQueue((batch_fn(s) for s in range(start, tcfg.steps)),
                      timeout_s=prefetch_timeout_s, backup_fn=batch_fn)
    losses = []
    t0 = time.time()
    try:
        for step in range(start, tcfg.steps):
            batch = q.get(step)
            if injector is not None:
                injector.check(step)
            state, metrics = step_fn(state, batch)
            if (step + 1) % tcfg.log_every == 0 or step + 1 == tcfg.steps:
                loss = float(metrics["loss"])
                losses.append((step + 1, loss))
                log_fn(f"[train] step {step + 1}/{tcfg.steps} "
                       f"loss={loss:.4f} "
                       f"gnorm={float(metrics['grad_norm']):.3f} "
                       f"({(time.time() - t0):.1f}s)")
            if ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save(step + 1, state)
    finally:
        if ckpt is not None:   # a restart must find the last save whole
            ckpt.wait()
    return RunResult(final_state=state, losses=losses,
                     straggler_timeouts=q.stats.timeouts)
