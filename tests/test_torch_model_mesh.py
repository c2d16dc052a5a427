"""The model mesh of the port (``launch/mesh.py``, ``distributed/sharding.py``,
the ``*_axes`` rules, the ring matmul, ``compressed_psum``, GPipe, the
sharded steps and the resharded restore) against the JAX reference.

* Every leaf's spec of all ten archs at full width, on the (16, 16) and
  (2, 16, 16) production meshes, equals the reference's ``spec_for_leaf``
  over its own ``*_axes`` trees and ``jax.eval_shape`` shapes, on a stub
  mesh (``spec_for_leaf`` reads the axis names and the mesh shape
  alone); the port side uses its own rules and its ``meta`` shapes.
* The gloo cases run once a module on 8 CPU ranks
  (``tests/torch_mesh.py``'s ``program_model_mesh``): the ring matmul
  against ``x @ w`` (the reference's tolerance), ``compressed_psum``
  against the reference's ``quantize`` on the host with the same shared
  scale, GPipe against the sequential stages, the sharded step on a
  (2, 2) mesh against the port's single-device step (which
  ``test_optimizer_steps_equal_reference`` holds to the reference), and
  a checkpoint saved at world size 1 restored on 2 and 4 ranks.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh as tm
from repro.configs.base import get_arch as j_get_arch
from repro.distributed.sharding import spec_for_leaf as j_spec_for_leaf
from repro.launch import mesh as j_mesh
from repro.models import dimenet as JDM
from repro.models import fm as JFM
from repro.models import gnn as JG
from repro.models import nequip as JNQ
from repro.models import transformer as JT
from repro.train import compression as j_compression
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.families import gnn_axes, gnn_init
from repro_torch.distributed.sharding import (Sharding, cast_float_leaves,
                                              spec_for_leaf, tree_shardings)
from repro_torch.errors import ConfigError
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import fm as FM
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_one_thread import one_torch_thread  # noqa: F401

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
KEY = jax.ShapeDtypeStruct((2,), jnp.uint32)


def j_stub(shape, names):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def t_stub(shape, names):
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def j_axes_and_shapes(arch_id: str):
    arch = j_get_arch(arch_id)
    cfg = arch.model_cfg
    if arch.family == "lm":
        return JT.lm_axes(cfg), jax.eval_shape(lambda k: JT.init_lm(k, cfg),
                                               KEY)
    if arch.family == "recsys":
        return JFM.fm_axes(cfg), jax.eval_shape(
            lambda k: JFM.init_fm(k, cfg), KEY)
    init, axes = {"gin": (JG.init_gin, JG.gin_axes),
                  "egnn": (JG.init_egnn, JG.egnn_axes),
                  "nequip": (JNQ.init_nequip, JNQ.nequip_axes),
                  "dimenet": (JDM.init_dimenet, JDM.dimenet_axes)
                  }[arch.gnn_kind]
    return axes(cfg), jax.eval_shape(lambda k: init(k, cfg), KEY)


def _key(k) -> str:
    return str(k.key if hasattr(k, "key") else k.idx)


def j_specs(arch_id: str, shape, names) -> dict:
    """The reference's spec of every leaf, by "/"-joined path."""
    from jax.sharding import PartitionSpec as P
    arch = j_get_arch(arch_id)
    axes, shapes = j_axes_and_shapes(arch_id)
    mesh = j_stub(shape, names)

    def is_axes(t):
        return isinstance(t, tuple) and all(
            isinstance(x, (str, tuple, list, type(None))) for x in t)
    specs = jax.tree_util.tree_map(
        lambda lg, s: j_spec_for_leaf(tuple(lg), tuple(s.shape),
                                      arch.param_rules, mesh),
        axes, shapes, is_leaf=is_axes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_key(k) for k in path): tuple(spec)
            for path, spec in flat}


def t_axes_and_leaves(arch_id: str) -> tuple[dict, dict]:
    arch = get_arch(arch_id)
    if arch.family == "lm":
        model = T.init_lm(arch.model_cfg, device="meta")
        axes = T.lm_axes(arch.model_cfg)
    elif arch.family == "recsys":
        model = FM.init_fm(arch.model_cfg, device="meta")
        axes = FM.fm_axes(arch.model_cfg)
    else:
        model = gnn_init(arch, device="meta")
        axes = gnn_axes(arch)
    return axes, T.reference_leaves(model)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch_id", list_archs())
def test_specs_equal_reference_at_full_width(arch_id, mesh_name):
    shape, names = MESHES[mesh_name]
    want = j_specs(arch_id, shape, names)
    axes, leaves = t_axes_and_leaves(arch_id)
    assert set(axes) == set(leaves) == set(want)
    stub = t_stub(shape, names)
    got = {k: spec_for_leaf(axes[k], tuple(leaves[k].shape),
                            get_arch(arch_id).param_rules, stub)
           for k in axes}
    assert got == want
    # every spec is a DTensor layout (no tuple entry out of mesh order)
    for k, spec in got.items():
        sh = Sharding(stub, spec)
        assert len(sh.placements) == len(names)
        assert math.prod(sh.shard_shape(leaves[k].shape)) * math.prod(
            shape[i] for i, p in enumerate(sh.placements)
            if p.is_shard()) == leaves[k].numel()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_helpers_equal_reference(mesh_name):
    shape, names = MESHES[mesh_name]
    j, t = j_stub(shape, names), t_stub(shape, names)
    assert t_mesh.mesh_axes(t) == j_mesh.mesh_axes(j)
    assert t_mesh.dp_axes(t) == j_mesh.dp_axes(j)
    assert t_mesh.dp_size(t) == j_mesh.dp_size(j)


def test_sharding_rule_engine_fallbacks():
    mesh = t_stub((1,), ("model",))
    # divisibility fallback
    assert spec_for_leaf(("embed", "heads", "head_dim"), (64, 3, 16),
                         {"heads": "model", "embed": None}, mesh) == \
        (None, "model", None)
    mesh4 = t_stub((4,), ("model",))
    assert spec_for_leaf(("embed", "heads", "head_dim"), (64, 3, 16),
                         {"heads": "model"}, mesh4) == (None, None, None)
    # collision fallback: same mesh axis twice -> second replicated
    assert spec_for_leaf(("experts", "embed", "ffn"), (4, 8, 16),
                         {"experts": "model", "ffn": "model"}, mesh) == \
        ("model", None, None)
    # an axis the mesh lacks replicates; () leaves a scalar replicated
    assert spec_for_leaf(("embed",), (8,), {"embed": "pod"}, mesh) == \
        (None,)
    assert spec_for_leaf((), (3, 4), {}, mesh) == ()


def test_sharding_placements_split_in_mesh_order():
    mesh = t_stub((2, 4), ("data", "model"))
    sh = Sharding(mesh, (("data", "model"), None))
    assert [str(p) for p in sh.placements] == ["S(0)", "S(0)"]
    assert sh.shard_shape((16, 3)) == (2, 3)
    # device (d, m) holds chunk d * 4 + m of the dim, as P(("data",
    # "model")) does
    for d in range(2):
        for m in range(4):
            rows = sh.local_slices((16, 3), (d, m))[0]
            assert (rows.start, rows.stop) == ((d * 4 + m) * 2,
                                               (d * 4 + m + 1) * 2)
    with pytest.raises(ConfigError, match="mesh's order"):
        Sharding(mesh, (("model", "data"),)).placements
    mixed = Sharding(mesh, ("model", "data"))
    assert [str(p) for p in mixed.placements] == ["S(1)", "S(0)"]
    assert mixed.local_slices((8, 6), (1, 2)) == (slice(4, 6), slice(3, 6))


def test_tree_shardings_and_cast_float_leaves():
    cfg = get_arch("qwen3-0.6b").smoke_cfg
    leaves = T.reference_leaves(T.init_lm(cfg, device="meta"))
    shard = tree_shardings(T.lm_axes(cfg), leaves, {"heads": "model"},
                           t_stub((1, 2), ("data", "model")))
    assert shard["blocks/0/attn/wq"].spec == (None, None, "model", None)
    cast = cast_float_leaves(leaves, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 and t.device.type == "meta"
               for t in cast.values())
    with pytest.raises(ConfigError):
        tree_shardings({"a": (None,)}, leaves, {}, t_stub((1,), ("d",)))


def test_fake_mesh_starts_and_destroys_its_group():
    with t_mesh.fake_mesh((2, 4), ("data", "model")) as mesh:
        assert tuple(mesh.shape) == (2, 4)
        assert dist.get_world_size() == 8
        with pytest.raises(ConfigError, match="already has one"):
            with t_mesh.fake_mesh((2,), ("data",)):
                pass
        with pytest.raises(ConfigError, match="world of 256"):
            t_mesh.make_production_mesh(device_type="cpu")
        test = t_mesh.make_test_mesh(2, 2)
        assert test.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    with t_mesh.fake_mesh((16, 16), ("data", "model")):
        mesh = t_mesh.make_production_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    with pytest.raises(ConfigError, match="initialised process group"):
        t_mesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_set_unroll_and_act_spec_change_nothing_on_plain_tensors():
    cfg = get_arch("olmoe-1b-7b").smoke_cfg
    model = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    want = T.lm_loss(model, tokens, compute_dtype=torch.float32)
    L.set_unroll(True)
    T.set_act_spec(("anything",))
    try:
        got = T.lm_loss(model, tokens, compute_dtype=torch.float32,
                        moe_spec=(("data",), "model"))
    finally:
        L.set_unroll(False)
        T.set_act_spec(None)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the gloo program
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks() -> list[dict]:
    """Every rank's results of :func:`torch_mesh.program_model_mesh`."""
    return tm.run_ranks(tm.program_model_mesh, 8, timeout=420)


def test_ring_matmul_equals_reference(ranks):
    x, w = tm.ring_operands()
    got = np.concatenate([r["ring"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-5)
    # n - 1 ring exchanges of the K block, in the ledger
    kb = x.shape[1] // len(ranks)
    for r in ranks:
        assert r["ring_ledger"] == [("ring_matmul_shift",
                                     x.shape[0] * kb * 4)] * (len(ranks) - 1)


def test_compressed_psum_equals_reference_quantize(ranks):
    g, res = tm.psum_operands()
    n = tm.PSUM_RANKS
    peak = jnp.max(jnp.stack([jnp.max(jnp.abs(jnp.asarray(g[i])
                                              + jnp.asarray(res[i])))
                              for i in range(n)]))
    scale = peak / 127.0 + 1e-12
    codes, resid = [], []
    for i in range(n):
        q, _, r = j_compression.quantize(jnp.asarray(g[i]),
                                         jnp.asarray(res[i]), scale=scale)
        codes.append(np.asarray(q).astype(np.int32))
        resid.append(np.asarray(r))
    want_mean = (np.sum(codes, axis=0).astype(np.float32)
                 * np.float32(scale) / np.float32(n))
    exact = (g + res).mean(axis=0)
    for i in range(n):
        mean, new_res = ranks[i]["psum"]
        np.testing.assert_array_equal(new_res, resid[i])
        np.testing.assert_array_equal(mean, want_mean)
        assert np.abs(mean - exact).max() <= 4 * float(scale)
    assert all("psum" not in r for r in ranks[n:])


def test_gpipe_equals_sequential(ranks):
    ws, x = tm.gpipe_operands()
    want = x
    for i in range(4):
        want = np.tanh(want @ ws[i])
    for r in ranks:
        np.testing.assert_allclose(r["gpipe"], want, rtol=1e-5, atol=1e-6)
        assert r["bubble"] == pytest.approx(3 / 7)


@pytest.mark.parametrize("arch_id", tm.STEP_ARCHS)
def test_sharded_step_equals_single_device(ranks, arch_id):
    for r in ranks[:4]:
        case = r["steps"][arch_id]
        assert abs(case["loss"] - case["plain_loss"]) <= \
            1e-6 * abs(case["plain_loss"])
        worst = max(case["rel"], key=case["rel"].get)
        assert case["rel"][worst] <= 1e-5, (worst, case["rel"][worst])
    # the case sharded something: a leaf over "model", the batch over
    # "data"
    specs = ranks[0]["steps"][arch_id]["specs"]
    if arch_id != "gin-tu":
        assert any("model" in s for s in specs.values())


@pytest.mark.parametrize("P", tm.RESTORE_RANKS)
def test_resharded_restore_gives_each_rank_its_block(ranks, P):
    tree = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in tm.restore_tree().items()}
    names = ("data", "model")
    shape = (P // 2, 2) if P == 4 else (1, P)
    sizes = dict(zip(names, shape))
    seen_sharded = False
    for rank in range(P):
        rec = ranks[rank][("restore", P)]
        assert rec["step"] == 7
        assert rec["dtypes"]["final_norm"] == "torch.bfloat16"
        coord = dict(zip(names, rec["coord"]))
        for k, full in tree.items():
            block = full
            for d, entry in enumerate(rec["specs"][k]):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                n = math.prod(sizes[a] for a in axes)
                i = 0
                for a in axes:
                    i = i * sizes[a] + coord[a]
                seen_sharded |= n > 1
                block = np.split(block, n, axis=d)[i]
            np.testing.assert_array_equal(rec["blocks"][k], block)
    assert seen_sharded
    assert all(("restore", P) not in r for r in ranks[P:])
