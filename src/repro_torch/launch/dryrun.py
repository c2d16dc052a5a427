"""Multi-pod dry run, the port of ``repro/launch/dryrun.py``: trace every
(arch x shape) cell on the production meshes over a fake process group
and extract the roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh multi

The reference lowers and compiles each cell with XLA on simulated
devices and reads the compiled program: ``cost_analysis()`` for FLOPs
and bytes accessed, the HLO text for collective bytes.  The port runs
the cell's step once, as rank 0 of a fake group of 256 or 512 ranks
(:func:`~repro_torch.launch.mesh.fake_mesh`), on DTensor arguments
whose local blocks are fake tensors (nothing is allocated), under one
counter, :class:`CostCounter`, a dispatch mode that sees every local
aten op DTensor runs on this rank:

* FLOPs a device: ``torch.utils.flop_counter``'s formulas on the local
  ops (a matmul sharded four ways counts a quarter);
* HBM bytes a device: the input and output bytes of every local op but
  views and allocations.  Every op reads and writes memory: no credit
  for fusion, so this overstates what a fused program moves;
* collectives: each ``_c10d_functional`` collective DTensor issues, by
  kind, its output bytes and a count, with the reference's wire
  convention (an all-reduce moves twice its payload).

Memory is a rank's bytes of the arguments, outputs and donated state,
from their shardings; temporaries are left out (nothing tracks the live
fake storage).  LM cells of five or more layers are costed through two
(or, with gradient accumulation past 2, four) reduced-layer probe twins
and extrapolated, as the reference does, so a 61-layer cell costs a few
small traces.  The constants are the H100 SXM's spec sheet (dense bf16,
HBM3, one NVLink 4 direction); one link rate stands for every mesh axis,
as the reference's single ICI rate does, though a 16 x 16 mesh of
8-card nodes spans 32 nodes whose InfiniBand is slower (not modelled).

Artifacts: one JSON a cell under ``artifacts/dryrun_torch/<mesh>/``.
``--jobs N`` traces N cells at once, each in a process of its own.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import multiprocessing as mp
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._op_schema import OutputSharding
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import all_archs, get_arch
from repro_torch.configs.families import build_cell
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, fake_mesh

# H100 SXM spec-sheet constants (a card): dense bf16 tensor-core FLOP/s,
# HBM3 bytes/s, NVLink 4 bytes/s in each direction
PEAK_FLOPS_BF16 = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 450e9
CONSTANTS_NOTE = ("H100 SXM spec sheet (NVIDIA H100 80GB HBM3, 700 W): "
                  "989.4e12 dense bf16 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s "
                  "NVLink 4 a direction, one link rate for every mesh axis")

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
_C10D_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
# ops that move no bytes of their own: views, allocations, metadata
_FREE = {"aten._unsafe_view", "aten.alias", "aten.detach", "aten.lift_fresh",
         "aten.lift_fresh_copy", "aten.empty", "aten.empty_strided",
         "aten.empty_like", "aten.new_empty", "aten.new_empty_strided",
         "aten._local_scalar_dense"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def empty_collectives() -> dict:
    out = {k: 0 for k in COLLECTIVE_KINDS}
    out["count"] = 0
    out["wire_bytes"] = 0
    return out


def wire_bytes(coll: dict) -> int:
    """The reference's wire convention: a ring all-reduce moves about
    twice its payload, the other collectives about once."""
    return (2 * coll["all-reduce"] + coll["all-gather"]
            + coll["reduce-scatter"] + coll["all-to-all"]
            + coll["collective-permute"])


class CostCounter(TorchDispatchMode):
    """Counts this rank's FLOPs, HBM bytes and collectives.  An op on a
    DTensor is passed on (``NotImplemented``) to DTensor, whose local ops
    and collectives then come back here; the ops DTensor runs to infer
    output shapes (global, not this rank's) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collectives = empty_collectives()
        self.fallbacks = 0
        self._suspended = 0
        self._patched = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        name = func.overloadpacket._qualified_op_name.replace("::", ".")
        if name.startswith("_c10d_functional."):
            kind = _C10D_KIND.get(name.split(".", 1)[1])
            if kind is not None:
                self.collectives[kind] += sum(
                    _nbytes(t) for t in tree_flatten(out)[0])
                self.collectives["count"] += 1
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _FREE \
                and not name.startswith(("prim.", "aten.sym_")):
            self.hbm_bytes += sum(_nbytes(t) for t in flat) + \
                sum(_nbytes(t) for t in tree_flatten(out)[0])
        return out

    def __enter__(self):
        self._patched = []
        for owner, name, make in self._patches():
            orig = getattr(owner, name, None)
            if orig is None:       # not in this PyTorch release
                continue
            self._patched.append((owner, name, orig))
            setattr(owner, name, make(orig))
        return super().__enter__()

    def _patches(self) -> list:
        """(owner, attribute, wrapper of the original) for each of
        DTensor's internals the count goes around; an attribute a
        PyTorch release lacks is left alone."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import (_dispatch, _redistribute,
                                              placement_types)
        from torch.distributed.tensor._dispatch import OpDispatcher
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        counter = self

        def uncounted(orig):
            # DTensor infers an op's output shapes by running it on the
            # global shapes: not this rank's work
            def run(*a, **k):
                counter._suspended += 1
                try:
                    return orig(*a, **k)
                finally:
                    counter._suspended -= 1
            return run

        def index_arithmetic(orig):
            # a strided shard's offsets come from an arange and a tolist,
            # which the fake mode cannot answer: run for real, uncounted
            def run(*a, **k):
                with unset_fake_temporarily():
                    return uncounted(orig)(*a, **k)
            return run

        def not_tracing(orig):
            # under a fake mode DTensor takes itself to be tracing
            # (symbolic shapes) and caches no sharding and no
            # redistribution plan; the dry run's shapes are static
            return lambda: False

        def all_to_all(orig):
            # on a CPU mesh DTensor turns a shard-to-shard all-to-all into
            # an all-gather and a chunk (gloo has no all-to-all): count it
            # as the all-to-all it stands for, as a card's mesh runs it
            def run(inp, gather_dim, shard_dim, mesh, mesh_dim):
                if mesh.device_type != "cpu" or not isinstance(
                        inp, FakeTensor):
                    return orig(inp, gather_dim, shard_dim, mesh, mesh_dim)
                counter.collectives["all-to-all"] += _nbytes(inp)
                counter.collectives["count"] += 1
                shape = list(inp.shape)
                shape[gather_dim] *= mesh.size(mesh_dim)
                shape[shard_dim] //= mesh.size(mesh_dim)
                return inp.new_empty(shape)
            return run

        def replicate_on_failure(orig):
            # where DTensor finds no sharding for an op (strided shards
            # after some reshapes, an op with no rule), replicate the op's
            # inputs and run it whole, as GSPMD does when it must; counted
            def run(disp, *a, **k):
                try:
                    return orig(disp, *a, **k)
                except Exception:
                    info = next((x for x in (*a, *k.values())
                                 if type(x).__name__ == "OpInfo"), None)
                    if info is None:
                        raise
                    rep = _replicated_schema(info.schema)
                    try:
                        out = disp.sharding_propagator.\
                            propagate_op_sharding_non_cached(rep)
                    except Exception:
                        out = None
                    if out is None:
                        raise
                    counter.fallbacks += 1
                    if out.needs_redistribute:
                        return out
                    return OutputSharding(output_spec=out.output_spec,
                                          redistribute_schema=rep,
                                          needs_redistribute=True)
            return run

        return [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                 uncounted),
                (getattr(placement_types, "_StridedShard", None),
                 "local_shard_size_and_offset", index_arithmetic),
                (_dispatch, "_are_we_tracing", not_tracing),
                (_redistribute, "_are_we_tracing", not_tracing),
                (placement_types, "shard_dim_alltoall", all_to_all),
                (OpDispatcher, "_propagate_op_sharding_dispatch_slow_path",
                 replicate_on_failure)]

    def __exit__(self, *exc):
        for owner, name, orig in self._patched:
            setattr(owner, name, orig)
        return super().__exit__(*exc)


def _replicated_schema(schema):
    """``schema`` with every DTensor argument replicated."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSchema
    from torch.utils._pytree import tree_map

    def rep(a):
        if isinstance(a, DTensorSpec):
            return DTensorSpec(a.mesh, (Replicate(),) * a.mesh.ndim,
                               tensor_meta=a.tensor_meta)
        return a
    return OpSchema(schema.op, tree_map(rep, schema.args_schema),
                    tree_map(rep, schema.kwargs_schema),
                    schema_info=schema.schema_info)


def collective_bytes(counter: CostCounter) -> dict:
    """The collectives a counter saw: payload bytes by kind, ``count`` and
    ``wire_bytes`` (the reference's ``collective_bytes`` reads the same
    from the compiled HLO text)."""
    out = dict(counter.collectives)
    out["wire_bytes"] = wire_bytes(out)
    return out


def roofline_terms(flops: float, hbm_bytes: float, wire: float) -> dict:
    """A device's seconds for each roofline term (H100 SXM constants)."""
    return {"compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": hbm_bytes / HBM_BW,
            "collective_s": wire / LINK_BW}


def _trace_metrics(cell) -> tuple[float, float, dict]:
    """(FLOPs, HBM bytes, collectives) of one trace of ``cell``; the ops
    the counter had to replicate are added to ``cell.replicated_ops``."""
    counter = CostCounter()
    cell.trace(counter)
    cell.replicated_ops += counter.fallbacks
    return float(counter.flops), float(counter.hbm_bytes), \
        collective_bytes(counter)


def _replicated_ops(cell) -> int:
    """The ops replicated by the counter's fallback over ``cell``'s
    traces (its probes' when it has them)."""
    if cell.probe is None:
        return cell.replicated_ops
    twins = cell.probe[1:3] if cell.probe[0] == "linear" else cell.probe[1]
    return sum(c.replicated_ops for c in twins)


def _probe_costs(cell) -> tuple[float, float, dict]:
    """Trace the probe twins and extrapolate every cost metric.

    linear:   two layer counts; cost(L) = a + cL.
    bilinear: (layers x accum) grid; cost(L, A) = a + bA + cL + dAL,
    exact because layers (within a group) and micro-batches repeat the
    same ops."""
    kind = cell.probe[0]
    if kind == "linear":
        _, c1, c2, l1, l2, lf = cell.probe
        f1, h1, k1 = _trace_metrics(c1)
        f2, h2, k2 = _trace_metrics(c2)
        scale = (lf - l1) / (l2 - l1)

        def ext(a, b):
            return a + (b - a) * scale
        coll = {k: int(ext(k1[k], k2[k])) for k in k1}
        return ext(f1, f2), ext(h1, h2), coll
    _, cells, (l1, l2), (a1, a2), (lf, af) = cell.probe
    m = [_trace_metrics(c) for c in cells]  # (l1,a1)(l1,a2)(l2,a1)(l2,a2)

    def ext(c11, c12, c21, c22):
        d = (c22 - c21 - c12 + c11) / ((l2 - l1) * (a2 - a1))
        cc = (c21 - c11) / (l2 - l1) - d * a1
        b = (c12 - c11) / (a2 - a1) - d * l1
        a = c11 - b * a1 - cc * l1 - d * a1 * l1
        return a + b * af + cc * lf + d * af * lf

    flops = ext(*(x[0] for x in m))
    hbm = ext(*(x[1] for x in m))
    coll = {k: int(max(0, ext(*(x[2][k] for x in m)))) for k in m[0][2]}
    return flops, hbm, coll


def mesh_spec(mesh_name: str, small: bool) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh, or with ``small`` the
    reference's shakeout mesh ((2, 4), or (2, 2, 2) multi-pod)."""
    if small:
        return (((2, 2, 2), ("pod", "data", "model")) if mesh_name == "multi"
                else ((2, 4), ("data", "model")))
    return MULTI_POD if mesh_name == "multi" else SINGLE_POD


def _memory(cell) -> dict:
    arg, out, alias = cell.arg_bytes(), cell.out_bytes, cell.donated
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "alias_size_in_bytes": alias,
            "total_bytes_per_device": arg + out - alias,
            "note": "arguments, outputs and donated state from their "
                    "shardings; temporaries not counted"}


def run_cell(arch_id: str, shape_name: str, mesh_name: str, *,
             out_dir: str = "artifacts/dryrun_torch", small: bool = False,
             arch_obj=None) -> dict:
    """Build and trace one cell on a fake mesh; write and return its
    record.  ``arch_obj`` overrides the registered spec (variant
    runs)."""
    arch = arch_obj if arch_obj is not None else get_arch(arch_id)
    shape, names = mesh_spec(mesh_name, small)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": list(shape), "axes": list(names)}
    if shape_name in arch.skip_shapes:
        rec["status"] = "skipped"
        rec["reason"] = arch.skip_shapes[shape_name]
        _write(rec, out_dir)
        return rec
    t0 = time.time()
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)   # DTensor's advice on 2-D all-reduces
    try:
        with fake_mesh(shape, names) as mesh:
            fake_mode = FakeTensorMode()
            cell = build_cell(arch, shape_name, mesh, fake_mode)
            rec["desc"] = cell.static_desc
            rec["build_s"] = round(time.time() - t0, 2)
            t1 = time.time()
            if cell.probe is not None:
                flops, hbm, coll = _probe_costs(cell)
                rec["cost_source"] = ("probe-extrapolated trace of the local "
                                      "ops; bytes with no fusion credit")
            else:
                flops, hbm, coll = _trace_metrics(cell)
                rec["cost_source"] = ("traced local ops; bytes with no "
                                      "fusion credit")
            rec["trace_s"] = round(time.time() - t1, 2)
            rec["replicated_ops"] = _replicated_ops(cell)
            rec["memory"] = _memory(cell)
        coll["wire_bytes"] = wire_bytes(coll)
        rec.update({"status": "ok", "flops_per_device": flops,
                    "hbm_bytes_per_device": hbm, "collectives": coll,
                    "roofline": roofline_terms(flops, hbm,
                                               coll["wire_bytes"]),
                    "constants": CONSTANTS_NOTE})
        terms = rec["roofline"]
        rec["dominant"] = max(terms, key=terms.get)
    except Exception as e:   # noqa: BLE001 - the record carries it
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
    finally:
        log.setLevel(level)
    rec["wall_s"] = round(time.time() - t0, 2)
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir: str):
    d = os.path.join(out_dir, rec["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="tiny shakeout mesh instead of the production one")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own with its own fake group")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch.id, shape_name) for arch in all_archs()
                 for shape_name in arch.shapes]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    run = functools.partial(run_cell, mesh_name=args.mesh,
                            out_dir=args.out, small=args.small)
    if args.jobs > 1:
        pool = ProcessPoolExecutor(args.jobs,
                                   mp_context=mp.get_context("spawn"))
        futures = [pool.submit(run, a, s) for a, s in cells]
        records = (f.result() for f in futures)
    else:
        pool = None
        records = (run(a, s) for a, s in cells)
    n_ok = n_skip = n_err = 0
    for (arch_id, shape_name), rec in zip(cells, records):
        status = rec["status"]
        n_ok += status == "ok"
        n_skip += status == "skipped"
        n_err += status == "error"
        if status == "ok":
            t = rec["roofline"]
            print(f"[{args.mesh}] {arch_id:18s} {shape_name:14s} OK "
                  f"trace={rec['trace_s']:7.1f}s "
                  f"comp={t['compute_s']:.2e}s mem={t['memory_s']:.2e}s "
                  f"coll={t['collective_s']:.2e}s dom={rec['dominant']}",
                  flush=True)
        elif status == "skipped":
            print(f"[{args.mesh}] {arch_id:18s} {shape_name:14s} SKIP "
                  f"({rec['reason'][:60]})", flush=True)
        else:
            print(f"[{args.mesh}] {arch_id:18s} {shape_name:14s} ERROR "
                  f"{rec['error'][:160]}", flush=True)
    if pool is not None:
        pool.shutdown()
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
