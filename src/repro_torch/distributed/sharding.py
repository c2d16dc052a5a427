"""Sharding rule engine of the model tier, the port of
``repro/distributed/sharding.py``: logical parameter axes -> mesh axes.

Models name every parameter leaf's axes with a tuple of logical names
(the ``*_axes`` rules of ``repro_torch.models``, ``{path: axes}`` over
:func:`repro_torch.models.transformer.reference_leaves`' paths).  An arch
config's ``param_rules`` map ``logical -> mesh axis`` (a name, a tuple of
names, or None); :func:`spec_for_leaf` turns (axes, shape, rules, mesh)
into the reference's ``PartitionSpec`` as a tuple, with its two rails:

* divisibility: a dim whose size the mesh axes do not divide is
  replicated (gemma3's one KV head cannot split 16 ways);
* collision: a mesh axis is used once a leaf; a later logical axis that
  maps to a used one is replicated (DeepSeek's MoE ``w_gate`` maps
  experts and ffn to "model": experts wins).

:class:`Sharding` is the port's ``NamedSharding``: a mesh and a spec,
whose :attr:`~Sharding.placements` are DTensor's (``Shard(d)`` on each
mesh dimension named at tensor dim ``d``, ``Replicate()`` elsewhere).  A
leaf becomes a DTensor with :func:`shard_tensor` (each rank keeps its
block of the full tensor) or, in the dry run, :func:`fake_dtensor` (a
local block under ``FakeTensorMode``, nothing allocated).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.errors import ConfigError


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axis) -> int:
    sizes = _sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def spec_for_leaf(logical: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """The reference's ``PartitionSpec`` of one leaf, as a tuple: an entry
    a dim, each None, a mesh axis name or a tuple of names.  ``mesh``
    needs ``mesh_dim_names`` and ``shape`` alone."""
    if len(logical) != len(shape) and logical != ():
        raise ConfigError(f"logical axes {logical} vs shape {shape}")
    names = tuple(mesh.mesh_dim_names)
    used: set = set()
    out = []
    for name, dim in zip(logical, shape):
        axis = rules.get(name)
        if axis is None:
            out.append(None)
            continue
        axes_t = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if any(a not in names for a in axes_t) or \
                any(a in used for a in axes_t) or \
                dim % _axis_size(mesh, axes_t) != 0:
            out.append(None)     # absent axis, collision, divisibility
            continue
        used.update(axes_t)
        out.append(tuple(axis) if isinstance(axis, list) else axis)
    return tuple(out)


class Sharding:
    """A mesh and a spec (:func:`spec_for_leaf`'s tuple; shorter than the
    tensor's rank leaves the trailing dims replicated)."""

    def __init__(self, mesh, spec: tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)
        self._placements = self._make_placements()

    def _make_placements(self) -> tuple:
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ConfigError(
                    f"spec entry {entry} names its mesh axes out of the "
                    f"mesh's order {tuple(names)}: DTensor shards a dim "
                    f"over mesh dims in mesh order only")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    @property
    def placements(self) -> tuple:
        return self._placements

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """A rank's block of a leaf of ``global_shape``."""
        shape = list(global_shape)
        sizes = list(self.mesh.shape)
        for i, p in enumerate(self._placements):
            if isinstance(p, Shard):
                shape[p.dim] //= sizes[i]
        return tuple(shape)

    def local_slices(self, global_shape, coordinate) -> tuple[slice, ...]:
        """The slices of a leaf that the rank at mesh ``coordinate``
        holds (mesh dims sharding one tensor dim split it in mesh order,
        the first outermost, as a ``PartitionSpec`` tuple does)."""
        start = [0] * len(global_shape)
        size = list(global_shape)
        for i, p in enumerate(self._placements):
            if isinstance(p, Shard):
                size[p.dim] //= self.mesh.shape[i]
                start[p.dim] += coordinate[i] * size[p.dim]
        return tuple(slice(s, s + n) for s, n in zip(start, size))

    def __repr__(self) -> str:
        return f"Sharding(spec={self.spec}, placements={self._placements})"


def tree_shardings(axes: dict, shapes: dict, rules: dict, mesh) -> dict:
    """{path: :class:`Sharding`} from {path: logical axes} and {path:
    anything with a ``shape``} over the same paths."""
    if set(axes) != set(shapes):
        raise ConfigError(f"axes and shapes differ: "
                          f"{sorted(set(axes) ^ set(shapes))}")
    return {k: Sharding(mesh, spec_for_leaf(tuple(axes[k]),
                                            tuple(shapes[k].shape), rules,
                                            mesh))
            for k in axes}


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def cast_float_leaves(shapes: dict, dtype: torch.dtype) -> dict:
    """{path: tensor} with every floating leaf re-declared in ``dtype``
    on the ``meta`` device (shapes only: nothing is allocated)."""
    return {k: torch.empty(t.shape, dtype=dtype if t.is_floating_point()
                           else t.dtype, device="meta")
            for k, t in shapes.items()}


def shard_tensor(t: torch.Tensor, sharding: Sharding) -> DTensor:
    """``t`` (the same full tensor on every rank of the mesh) as a
    DTensor of ``sharding``: this rank keeps its block, no collective
    runs."""
    coord = sharding.mesh.get_coordinate()
    local = t[sharding.local_slices(t.shape, coord)].contiguous()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def fake_dtensor(shape, dtype: torch.dtype, sharding: Sharding) -> DTensor:
    """A DTensor of global ``shape`` and ``sharding`` whose local block is
    made under the caller's ``FakeTensorMode`` (no memory)."""
    shape = tuple(shape)
    local = torch.empty(sharding.shard_shape(shape), dtype=dtype)
    stride = torch.empty(shape, dtype=dtype, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape, stride=stride)


def local_nbytes(t: torch.Tensor) -> int:
    """Bytes of a rank's block (a DTensor's local tensor, else ``t``)."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def flatten_axes(tree, prefix: str = "") -> dict[str, tuple]:
    """A nested rule tree (dicts and lists whose leaves are axes tuples,
    the reference's layout) as ``{"/"-joined path: axes}``."""
    if isinstance(tree, tuple):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten_axes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
