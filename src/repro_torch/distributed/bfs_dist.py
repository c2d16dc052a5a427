"""Mesh helpers for mesh-native BLEST BFS (DESIGN §2.4), the port of
``repro/distributed/bfs_dist.py``.

The layers that use a mesh:

* build: :func:`repro_torch.core.bvss.build_sharded_bvss` (row partition —
  or the 2-D row × column partition when handed a ``(rows, cols)`` shape —
  padded to a common per-shard VSS count), and
  :func:`~repro_torch.core.bvss.shard_to_device`, which hands a rank its
  own block;
* prep:  :func:`repro_torch.core.policy.prepare` with ``mesh=...`` — the
  single sharded-prep entry point (1-D and 2-D meshes dispatch on the
  number of mesh dimensions);
* loop:  the same level step on every rank's local rows (``core/bfs.py``)
  — 1-D: frontier-word all-gather + all-reduced convergence; 2-D: butterfly
  OR all-reduce over the column axis + butterfly segment exchange over the
  row axis (``distributed/collectives.py``).

The reference's ``problem_specs``/``state_specs`` are the PartitionSpecs
``shard_map`` reads; SPMD ranks that each hold their own block have no
reader for them, so they are not ported.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.collectives import (all_gather_tiled,
                                                 axis_size, record_comm)
from repro_torch.errors import ConfigError

#: the mesh axis the BVSS row partition maps onto
BFS_AXIS = "data"
#: the second mesh axis of the 2-D partition: frontier-word column blocks
COL_AXIS = "col"

DEVICE_TYPES = ("cuda", "cpu")


def _check_ranks(n_ranks: int, device_type: str) -> None:
    """Over-requesting ranks (or cards) is a :class:`ConfigError`."""
    if device_type not in DEVICE_TYPES:
        raise ConfigError(f"mesh device_type must be one of {DEVICE_TYPES}, "
                          f"got {device_type!r}")
    if not dist.is_initialized():
        raise ConfigError(
            "a BFS mesh needs an initialised process group: start one "
            "process per rank and call torch.distributed.init_process_group "
            "(backend 'nccl' on CUDA, 'gloo' on the CPU) in each")
    world = dist.get_world_size()
    if n_ranks > world:
        raise ConfigError(
            f"requested {n_ranks} ranks, only {world} in the process group "
            f"(start {n_ranks} processes, one per rank)")
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_ranks > have:
            raise ConfigError(
                f"requested {n_ranks} CUDA ranks, only {have} cards "
                f"available (one rank a card; device_type='cpu' runs the "
                f"ranks on the CPU)")


def _make_mesh(device_type: str, shape: tuple[int, ...],
               names: tuple[str, ...]) -> DeviceMesh:
    """A mesh over global ranks ``0 .. prod(shape) - 1``; every rank of the
    process group calls this (SPMD), also the ranks it leaves out."""
    n = math.prod(shape)
    _check_ranks(n, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if n == dist.get_world_size():
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def bfs_mesh(n_devices: int | None = None, axis: str = BFS_AXIS, *,
             device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` ranks of the process group
    (default: all of them), one rank a device.

    The BFS row partition is 1-D: rank d owns BVSS rows
    [d·rows_per_shard, (d+1)·rows_per_shard) — the slices that pull INTO
    its vertex range — and the σ-bit frontier words are the one
    all-gathered array.  ``device_type="cuda"`` (NCCL, the default) puts
    rank r on ``cuda:r``; ``"cpu"`` (gloo) runs the ranks on the CPU.

    Over-requesting ranks, or CUDA ranks past the cards there are, raises
    :class:`repro_torch.errors.ConfigError`."""
    if n_devices is None:
        _check_ranks(1, device_type)
        n_devices = dist.get_world_size()
    if n_devices < 1:
        raise ConfigError(f"a mesh needs at least one rank, got {n_devices}")
    return _make_mesh(device_type, (n_devices,), (axis,))


def bfs_mesh2d(rows: int, cols: int, *, row_axis: str = BFS_AXIS,
               col_axis: str = COL_AXIS, device_type: str = "cuda"
               ) -> DeviceMesh:
    """A ``rows × cols`` 2-D mesh over the first ``rows * cols`` ranks.

    Rank (i, j) owns the BVSS slices pulling its ROW block of vertices
    from its COLUMN block of frontier words, so per level it touches only
    ``1/cols`` of the frontier (DESIGN §2.4).  The 2-D engines require
    ``rows >= cols`` (the column blocks interleave inside row blocks, so
    the local column space ``rows · rps/cols`` must cover a row block);
    violations raise :class:`repro_torch.errors.ConfigError` here, at mesh
    construction — the earliest ingress."""
    if rows < 1 or cols < 1:
        raise ConfigError(f"mesh shape ({rows}, {cols}) must be positive")
    if rows < cols:
        raise ConfigError(
            f"2-D BFS mesh needs rows >= cols, got ({rows}, {cols}) — "
            f"the column partition interleaves inside row blocks, so "
            f"fewer rows than columns leaves column shards without a "
            f"full row block to pull from")
    return _make_mesh(device_type, (rows, cols), (row_axis, col_axis))


def mesh_is_2d(mesh: DeviceMesh) -> bool:
    """True for the 2-D row × column partition (two named axes)."""
    return len(mesh.mesh_dim_names) == 2


def mesh_rank_device(mesh, device: "str | torch.device | None" = None
                     ) -> torch.device:
    """The device this rank's shard lives on: ``cuda:r`` for rank r of a
    CUDA (NCCL) mesh, the CPU for a gloo one.  ``device`` is the caller's
    requested device (``PrepareOptions.device``; None means ``"cuda"``) and
    must be of the mesh's type: a CPU mesh under a CUDA request, or the
    other way round, is a :class:`ConfigError`, as is a mesh that is not a
    named :class:`DeviceMesh`."""
    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise ConfigError(
            f"mesh must be a torch.distributed DeviceMesh with named "
            f"dimensions (bfs_mesh / bfs_mesh2d build one), got "
            f"{type(mesh).__name__}")
    want = torch.device("cuda" if device is None else device)
    if want.type != mesh.device_type:
        raise ConfigError(
            f"the mesh runs on {mesh.device_type!r} but the options ask for "
            f"device {str(want)!r}; pass device={mesh.device_type!r} or "
            f"build the mesh with device_type={want.type!r}")
    if mesh.device_type == "cuda":
        return torch.device("cuda",
                            dist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def frontier_all_gather(fw_local: torch.Tensor, mesh,
                        axis: str = BFS_AXIS) -> torch.Tensor:
    """The flat frontier exchange of the 1-D level loop: all-gather this
    shard's freshly packed σ-bit frontier words into the global frontier
    replica (tiled, so shard k contributes words [k·lwords, (k+1)·lwords)).

    Every 1-D mesh-native engine routes its frontier exchange through this
    function.  Per-rank bytes are recorded in the
    :func:`~repro_torch.distributed.collectives.comm_ledger`, once a call."""
    n = axis_size(mesh, axis)
    record_comm("flat_all_gather",
                (n - 1) * fw_local.numel() * fw_local.element_size())
    return all_gather_tiled(fw_local, mesh.get_group(axis))
