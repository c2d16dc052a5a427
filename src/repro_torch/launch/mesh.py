"""Production meshes of the model tier, the port of ``repro/launch/mesh.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
process group the caller started (one process a rank, NCCL on the card):
the single-pod mesh is (16, 16) over ``("data", "model")``, the
multi-pod mesh (2, 16, 16) over ``("pod", "data", "model")``.  Data
parallelism shards the batch over ``("pod", "data")``, tensor and expert
parallelism shard over ``"model"``, and the optional pipeline stages
over ``"pod"`` (:mod:`repro_torch.distributed.pipeline`).

:func:`fake_mesh` is the same mesh in one process: a fake process group
of ``prod(shape)`` ranks (PyTorch's ``fake`` backend: every collective
returns at once and moves nothing), which the dry run
(:mod:`repro_torch.launch.dryrun`) traces a step over, as the reference
lowers its step over simulated devices.  The mesh functions are
functions, so importing this module starts no group.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.errors import ConfigError

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the default
    process group, whose world size must be the mesh's 256 or 512 ranks
    (else :class:`~repro_torch.errors.ConfigError`)."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    n = math.prod(shape)
    if not dist.is_initialized():
        raise ConfigError(
            f"the production mesh needs an initialised process group of {n} "
            f"ranks: start one process a rank and call "
            f"torch.distributed.init_process_group in each")
    if dist.get_world_size() != n:
        raise ConfigError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"needs a world of {n} ranks, the process group has "
            f"{dist.get_world_size()}")
    return _mesh(device_type, shape, names)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   device_type: str = "cpu") -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the first
    ``n_data · n_model`` ranks of the default group (gloo CPU ranks in
    the tests); every rank of the group calls it."""
    n = n_data * n_model
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise ConfigError(f"a ({n_data}, {n_model}) test mesh needs an "
                          f"initialised process group of at least {n} ranks")
    return _mesh(device_type, (n_data, n_model), ("data", "model"))


def _mesh(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(
        shape), mesh_dim_names=names)


@contextlib.contextmanager
def fake_mesh(shape: tuple, names: tuple):
    """A mesh of ``shape`` over ``names`` in this one process, as rank 0
    of a fake process group of ``prod(shape)`` ranks, destroyed on exit.
    Collectives over it return at once with their output shapes; under
    ``FakeTensorMode`` nothing is allocated.  A process that already has
    a default group is a :class:`~repro_torch.errors.ConfigError`."""
    if dist.is_initialized():
        raise ConfigError("fake_mesh starts its own process group, and this "
                          "process already has one")
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield _mesh("cpu", tuple(shape), tuple(names))
    finally:
        dist.destroy_process_group()


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: ranks along it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a production mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def dp_size(mesh) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))
