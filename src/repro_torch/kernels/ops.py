"""The kernel layer's one dispatch rule and its public entry points.

:func:`use_kernel` replaces the reference's ``resolve_interpret``
(``repro/kernels/ops.py``): every kernel entry point asks it which path
its operands take.

* CUDA tensors get the hand-written CUDA kernel, or an exception (a
  kernel that does not build, load or launch raises
  :class:`~repro_torch.errors.KernelBuildError`).
* CPU tensors get the kernel's plain PyTorch twin from ``ref.py``.

There is no third answer: no "kernel not built, use the twin" branch and
no environment override.  Mixed or other devices are a
:class:`~repro_torch.errors.ConfigError`.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ConfigError


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the operands are CUDA tensors (launch the kernel), False
    when they are CPU tensors (run the twin)."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        kind = next(iter(devices)).type
        if kind == "cuda":
            return True
        if kind == "cpu":
            return False
    raise ConfigError(
        f"kernel operands must all lie on one CUDA device or all on the "
        f"CPU, got {sorted(str(d) for d in devices)}")


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: tuple[int, ...]) -> None:
    """Validate a kernel operand before its pointer goes to C."""
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ConfigError(
            f"{name} must be a contiguous {dtype} tensor of shape {shape}, "
            f"got {t.dtype} {tuple(t.shape)} "
            f"({'contiguous' if t.is_contiguous() else 'strided'})")


def check_sigma(sigma: int) -> None:
    if not (isinstance(sigma, int) and 1 <= sigma <= 32 and 32 % sigma == 0):
        raise ConfigError(
            f"sigma must be a divisor of 32 in [1, 32], got {sigma!r}")


from .bvss_pull import bvss_pull                                  # noqa: E402
from .bvss_push import bvss_push, bvss_push_level                 # noqa: E402
from .frontier_finalize import (finalize_pack_sweep,               # noqa: E402
                                finalize_sweep)
from .mxu_pull import (bit_spmm, bvss_spmm, bvss_spmm_mark,       # noqa: E402
                       bvss_spmm_minplus, bvss_spmm_minplus_local,
                       bvss_spmm_t, bvss_spmm_t_local, bvss_spmm_w,
                       bvss_spmm_w_local)
from . import ref                                                 # noqa: E402

#: every hand-written kernel's entry point; each carries a ``launches``
#: count that grows by one per kernel launch (twin calls do not count)
KERNELS = (bvss_pull, bvss_push, bvss_push_level, finalize_pack_sweep,
           bvss_spmm, bvss_spmm_mark, bvss_spmm_w, bvss_spmm_t,
           bvss_spmm_minplus, finalize_sweep, bit_spmm)


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def pull_vss_kernel(masks: torch.Tensor, fbytes: torch.Tensor,
                    sigma: int = 8) -> torch.Tensor:
    """The engines' pull: :func:`bvss_pull` with a positional σ."""
    return bvss_pull(masks, fbytes, sigma=sigma)


def push_vss_kernel(masks: torch.Tensor, bits: torch.Tensor,
                    sigma: int = 8) -> torch.Tensor:
    """The engines' push: :func:`bvss_push` with a positional σ."""
    return bvss_push(masks, bits, sigma=sigma)


__all__ = ["use_kernel", "check_operand", "check_sigma", "bvss_pull",
           "bvss_push", "bvss_push_level", "finalize_pack_sweep",
           "finalize_sweep", "bit_spmm",
           "bvss_spmm", "bvss_spmm_mark", "bvss_spmm_w", "bvss_spmm_t",
           "bvss_spmm_minplus", "bvss_spmm_w_local", "bvss_spmm_t_local",
           "bvss_spmm_minplus_local", "KERNELS", "launch_counts",
           "reset_launch_counts", "pull_vss_kernel", "push_vss_kernel",
           "ref"]
