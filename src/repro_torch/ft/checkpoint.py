"""Checkpointing, the port of ``repro/ft/checkpoint.py``.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` a leaf and a
``manifest.json`` with each leaf's name, dtype and shape, the step and
the caller's extra metadata.  A save writes ``step_<N>.tmp`` and renames
it, so a crash mid-save never corrupts the latest checkpoint: a restart
picks the newest complete directory.

A tree is nested dicts, lists, tuples and named tuples of tensors (a
:class:`~repro_torch.train.TrainState`: the ``{path: tensor}`` params,
the optimizer state, the step); a leaf is named from its path in the
tree (``params.blocks_0_attn_wq``, ``opt_state.m.embed``).  Leaves are
saved as full host arrays and restored onto the device and dtype of the
tree they are restored into.  numpy has no bfloat16 and the port does
not use ``ml_dtypes``, so a bfloat16 leaf is stored as its ``uint16``
bits and the manifest records ``bfloat16``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

_SANITIZE = re.compile(r"[^A-Za-z0-9_.-]")


def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    raise TypeError(f"a checkpoint tree holds dicts, lists, tuples and "
                    f"tensors, not {type(node).__name__}")


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) for every leaf, in the tree's order; a name joins the
    keys of its path with dots, other characters made ``_``."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        name = _SANITIZE.sub("_", str(key))
        out += _leaf_paths(child, f"{prefix}.{name}" if prefix else name)
    return out


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    kids = [_rebuild(child, leaves) for _, child in _children(tree)]
    if isinstance(tree, dict):
        return dict(zip(tree, kids))
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a numpy array of the leaf's bits, its dtype's name)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _host_tree(tree) -> list[tuple[str, np.ndarray, str]]:
    out = [(name, *_to_host(leaf)) for name, leaf in _leaf_paths(tree)]
    names = [name for name, _, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"two leaves share a checkpoint name: {names}")
    return out


def _write(directory: str, step: int, host: list, extra: dict | None
           ) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, arr, dtype in host:
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "dtype": dtype, "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, *,
                    extra: dict | None = None) -> str:
    """Blocking save.  Returns the final checkpoint path."""
    return _write(directory, step, _host_tree(tree), extra)


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight at a
    time): ``save`` copies the tree to the host, then a thread writes
    it."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, *, extra: dict | None = None):
        self.wait()
        host = _host_tree(tree)

        def work():
            _write(self.directory, step, host, extra)
            retain(self.directory, self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        path = os.path.join(directory, d)
        if m and os.path.exists(os.path.join(path, "manifest.json")):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_checkpoint(directory: str) -> tuple[int, str] | None:
    cks = list_checkpoints(directory)
    return cks[-1] if cks else None


def retain(directory: str, keep: int):
    cks = list_checkpoints(directory)
    for _, path in cks[:-keep] if keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)


def _from_host(arr: np.ndarray, dtype: str, like: torch.Tensor
               ) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _named_leaves(tree, prefix: str = "") -> dict:
    """{name: leaf} of ``tree`` named as :func:`_leaf_paths` names them,
    where a leaf is anything but a dict, list or tuple (a sharding,
    None)."""
    if not isinstance(tree, (dict, list, tuple)):
        return {prefix: tree}
    out = {}
    for key, child in _children(tree):
        name = _SANITIZE.sub("_", str(key))
        out.update(_named_leaves(child, f"{prefix}.{name}" if prefix
                                 else name))
    return out


def _sharded(arr: np.ndarray, dtype: str, like: torch.Tensor, sharding
             ) -> torch.Tensor:
    """This rank's block of the saved leaf ``arr`` as a DTensor of
    ``sharding``, on the device and in the dtype of ``like`` (a DTensor's
    local tensor, or a plain tensor)."""
    from torch.distributed.tensor import DTensor
    local_like = like._local_tensor if isinstance(like, DTensor) else like
    coord = sharding.mesh.get_coordinate()
    host = _from_host(arr, dtype, torch.empty(0, dtype=like.dtype))
    local = host[sharding.local_slices(host.shape, coord)].contiguous()
    return DTensor.from_local(local.to(local_like.device), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=host.shape, stride=host.stride())


def restore_checkpoint(path: str, tree_like, *, shardings=None):
    """Restore into the structure of ``tree_like``: each leaf onto the
    device and dtype of ``tree_like``'s leaf of the same name.  Returns
    (tree, manifest).  A leaf the checkpoint lacks, or of another shape,
    raises ``ValueError``.

    ``shardings``, a tree of ``tree_like``'s structure whose leaves are
    :class:`~repro_torch.distributed.sharding.Sharding` or None, makes
    each such leaf a DTensor: every rank of its mesh reads the full leaf
    from the file and keeps its own block, so a checkpoint saved at one
    world size restores at another (the resharding of the reference's
    ``device_put`` with a sharding)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = _leaf_paths(tree_like)
    shards = _named_leaves(shardings) if shardings is not None else {}
    if shardings is not None and set(shards) != {n for n, _ in like}:
        raise ValueError("shardings do not match the tree's leaves")
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}
    missing = [name for name, _ in like if name not in dtypes]
    if missing:
        raise ValueError(f"checkpoint at {path} is missing leaves {missing}")
    out = []
    for name, leaf in like:
        sh = shards.get(name)
        arr = np.load(os.path.join(path, name + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {name} is {arr.shape}, the "
                             f"tree's is {tuple(leaf.shape)}")
        out.append(_from_host(arr, dtypes[name], leaf) if sh is None
                   else _sharded(arr, dtypes[name], leaf, sh))
    return _rebuild(tree_like, iter(out)), manifest


def restore_latest(directory: str, tree_like, *, shardings=None):
    latest = latest_checkpoint(directory)
    if latest is None:
        return None
    return restore_checkpoint(latest[1], tree_like, shardings=shardings)
