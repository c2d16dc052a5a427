"""The port's LM training (``repro_torch.train``, ``repro_torch.ft``,
``repro_torch.data``, ``repro_torch.launch.train``; ROADMAP.md queue 1
item 13c) against the JAX reference.

The parameters are the reference's ``init_lm`` pytree, carried into the
port as ``{path: tensor}`` leaves, and ``lm_loss`` runs the port's model
on them through ``transformer.bind``.  In float32 on the CPU:

* ``TokenPipeline`` batches equal the reference's exactly;
* one and two steps of AdamW (float32 and bfloat16 moments), SGD and
  Adafactor equal the reference's leaf by leaf within rtol 1e-5 (the
  bfloat16 moments within one bfloat16 step), and so do the schedules
  and global-norm clipping; int8 quantisation gives the reference's
  codes and scales;
* a 12-step ``train()`` gives the reference's losses within 1e-4;
* every case of ``tests/test_train_ft.py`` runs on the port: restart
  bit-exact, retention, a missing leaf raises, the straggler backup,
  ``elastic_remesh_plan`` equal to the reference's, quantisation error
  feedback, compressed training converging, accumulation equal to the
  big batch;
* the launcher trains OLMoE's and DeepSeek-V3's smoke configs with
  ``--device cpu``, its chaos drill (``examples/torch_train_lm.py``)
  survives the injected failure, and without a card the default
  raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JTokenPipeline
from repro.data import TokenPipelineConfig as JTokenPipelineConfig
from repro.ft import elastic_remesh_plan as j_elastic_remesh_plan
from repro.models import LMConfig as JLMConfig
from repro.models import transformer as JT
from repro.train import TrainConfig as JTrainConfig
from repro.train import compression as JC
from repro.train import optim as JO
from repro.train import train as jtrain
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.errors import ConfigError
from repro_torch.ft import (FailureInjector, PrefetchQueue, RestartManager,
                            SimulatedFailure, elastic_remesh_plan,
                            latest_checkpoint, list_checkpoints,
                            restore_checkpoint, retain, save_checkpoint)
from repro_torch.launch import train as tlaunch
from repro_torch.models import LMConfig
from repro_torch.models import transformer as TT
from repro_torch.train import TrainConfig, compression, optim, train
from repro_torch.train.loop import init_train_state, make_train_step
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
           d_head=16, d_ff=64, vocab=64)
_SETUP: dict = {}


def reference_params():
    if "params" not in _SETUP:
        _SETUP["params"] = JT.init_lm(jax.random.PRNGKey(0),
                                      JLMConfig(**CFG))
    return _SETUP["params"]


def leaves_of(tree) -> dict:
    """A reference pytree as the port's ``{path: tensor}`` leaves."""
    return {k: torch.from_numpy(np.array(v)) for k, v in
            TT.reference_paths(jax.tree_util.tree_map(np.asarray,
                                                      tree)).items()}


def setup_lm():
    """The port's (params, loss_fn, batch_fn) of ``test_train_ft.py``'s
    ``setup_lm``: the reference's weights and pipeline."""
    model = TT.init_lm(LMConfig(**CFG), device="cpu")
    pipe = TokenPipeline(TokenPipelineConfig(vocab=64, seq_len=32,
                                             global_batch=8))

    def loss_fn(p, b):
        return TT.lm_loss(TT.bind(model, p), torch.as_tensor(b).long(),
                          compute_dtype=torch.float32, remat=False)

    return leaves_of(reference_params()), loss_fn, pipe.batch


def quiet(_msg):
    pass


# ---------------------------------------------------------------------------
# data, optimizers, schedules, compression against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 2), (11, 4)])
def test_token_pipeline_batches_equal_reference(seed, shards):
    kw = dict(vocab=128, seq_len=16, global_batch=8, seed=seed)
    for shard in range(shards):
        got = TokenPipeline(TokenPipelineConfig(**kw), shard=shard,
                            num_shards=shards)
        want = JTokenPipeline(JTokenPipelineConfig(**kw), shard=shard,
                              num_shards=shards)
        for step in (0, 1, 7):
            b = got.batch(step)
            np.testing.assert_array_equal(b, want.batch(step))
            assert b.dtype == np.int32


def grads_like(params, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in TT.reference_paths(jax.tree_util.tree_map(
                np.asarray, params)).items()}


def unflatten(flat: dict, like):
    """``{path: array}`` back into the structure of the pytree ``like``."""
    paths = TT.reference_paths(jax.tree_util.tree_map(lambda x: 0, like))
    leaves = [jnp.asarray(flat[p]) for p in paths]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like), leaves)


def np_flat(tree) -> dict:
    return TT.reference_paths(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("name,moment", [
    ("adamw", "float32"), ("adamw", "bfloat16"), ("sgd", "float32"),
    ("adafactor", "float32")])
def test_optimizer_steps_equal_reference(name, moment):
    """Two steps from the reference's LM params (its stacked groups make
    the norms 2-D leaves: decayed by AdamW, factored by Adafactor) and
    seeded gradients: params, optimizer state and the global norm equal
    the reference's within rtol 1e-5."""
    params = reference_params()
    jcls, jinit, jupdate = JO.OPTIMIZERS[name]
    tcls, tinit, tupdate = optim.OPTIMIZERS[name]
    jkw, tkw = {}, {}
    if name == "adamw":
        jkw = dict(moment_dtype=getattr(jnp, moment))
        tkw = dict(moment_dtype=getattr(torch, moment))
    jcfg, tcfg = jcls(**jkw), tcls(**tkw)
    jp, js = params, jinit(params, jcfg)
    tp = leaves_of(params)
    ts = tinit(tp, tcfg)
    for step in range(2):
        g = grads_like(params, step)
        lr = 3e-2
        jp, js, jn = jupdate(unflatten(g, params), js, jp, jcfg,
                             jnp.float32(lr))
        tp, ts, tn = tupdate({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp, tcfg, torch.tensor(lr))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
        want = np_flat(jp)
        for k, v in tp.items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert int(ts.step) == int(js.step) == step + 1
        for field in ts._fields[1:]:
            want = np_flat(getattr(js, field))
            for k, v in getattr(ts, field).items():
                w = np.asarray(want[k], np.float32)
                if v.dtype == torch.bfloat16:   # one bfloat16 step
                    np.testing.assert_allclose(v.float().numpy(), w,
                                               rtol=2 ** -7, err_msg=k)
                else:
                    np.testing.assert_allclose(v.numpy(), w, rtol=1e-5,
                                               atol=1e-9, err_msg=k)


def test_schedules_and_clipping_equal_reference():
    for args in ((3e-3, 5, 40), (1e-2, 0, 10), (5e-4, 10, 10)):
        jfn, tfn = JO.warmup_cosine(*args), optim.warmup_cosine(*args)
        for step in (0, 1, 4, 5, 9, 10, 17, 40, 55):
            assert float(tfn(step)) == float(jfn(step)), (args, step)
    assert float(optim.constant_lr(0.25)(7)) == float(JO.constant_lr(0.25)(7))
    g = grads_like(reference_params(), 5)
    for max_norm in (0.5, 1e3):
        jg, jn = JO.clip_by_global_norm(unflatten(g, reference_params()),
                                        max_norm)
        tg, tn = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        want = np_flat(jg)
        for k, v in tg.items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6)


def test_quantize_equals_reference():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(64, 3)).astype(np.float32)
    res = rng.normal(scale=0.01, size=(64, 3)).astype(np.float32)
    jq, js, jr = JC.quantize(jnp.asarray(g), jnp.asarray(res))
    tq, ts, tr = compression.quantize(torch.from_numpy(g),
                                      torch.from_numpy(res))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-7)


def test_train_losses_equal_reference():
    """12 AdamW steps (warm-up and cosine) of ``train()``: every step's
    loss within 1e-4 of the reference's."""
    params, loss_fn, batch_fn = setup_lm()
    kw = dict(steps=12, log_every=1, peak_lr=1e-2, warmup=2)
    jcfg = JLMConfig(**CFG)
    want = jtrain(lambda p, b: JT.lm_loss(p, jcfg, jnp.asarray(b),
                                          compute_dtype=jnp.float32,
                                          remat=False),
                  reference_params(), batch_fn, JTrainConfig(**kw),
                  log_fn=quiet).losses
    got = train(loss_fn, params, batch_fn, TrainConfig(**kw),
                log_fn=quiet).losses
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 13))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-4)
    assert got[-1][1] < got[0][1]


# ---------------------------------------------------------------------------
# tests/test_train_ft.py on the port
# ---------------------------------------------------------------------------
def test_restart_bit_exact():
    params, loss_fn, batch_fn = setup_lm()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t1 = TrainConfig(steps=16, log_every=4, ckpt_every=4, ckpt_dir=d1,
                         peak_lr=1e-2, warmup=2)
        r1 = train(loss_fn, params, batch_fn, t1, log_fn=quiet)
        t2 = dataclasses.replace(t1, ckpt_dir=d2)
        inj = FailureInjector(fail_at_steps=(10,))
        mgr = RestartManager(max_restarts=2)
        r2 = mgr.run(lambda resume: train(loss_fn, params, batch_fn, t2,
                                          injector=inj, log_fn=quiet))
        assert mgr.stats.restarts == 1
        assert [s for s, _ in list_checkpoints(d2)] == [8, 12, 16]
        for k, a in r1.final_state.params.items():
            assert torch.equal(a, r2.final_state.params[k]), k
        assert r1.losses[-1][1] < r1.losses[0][1]
    # the caller's params are left as they were
    for k, v in leaves_of(reference_params()).items():
        assert torch.equal(params[k], v)


def test_restart_gives_up_after_max():
    mgr = RestartManager(max_restarts=1)

    def always_fail(resume):
        raise SimulatedFailure("boom")

    with pytest.raises(SimulatedFailure):
        mgr.run(always_fail)
    assert mgr.stats.restarts == 2  # initial + one retry counted as failures


def test_checkpoint_roundtrip_and_retention():
    """Leaves of every dtype come back bit for bit, the bfloat16 one stored
    as its uint16 bits with ``bfloat16`` in the manifest."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.zeros((4,), dtype=torch.int32),
                  torch.tensor(1.5, dtype=torch.bfloat16)]}
    with tempfile.TemporaryDirectory() as d:
        for step in (1, 2, 3):
            save_checkpoint(d, step, tree, extra={"note": "x"})
        retain(d, keep=2)
        cks = list_checkpoints(d)
        assert [s for s, _ in cks] == [2, 3]
        assert latest_checkpoint(d) == cks[-1]
        restored, manifest = restore_checkpoint(cks[-1][1], tree)
        assert manifest["step"] == 3 and manifest["extra"] == {"note": "x"}
        assert {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]} \
            == {"a": "float32", "b.0": "int32", "b.1": "bfloat16"}
        assert np.load(os.path.join(cks[-1][1], "b.1.npy")).dtype == \
            np.uint16
        assert not any(name.endswith(".tmp") for name in os.listdir(d))
        for a, b in ((tree["a"], restored["a"]),
                     (tree["b"][0], restored["b"][0]),
                     (tree["b"][1], restored["b"][1])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_restore_missing_leaf_raises():
    tree = {"a": torch.zeros((2,))}
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 1, tree)
        bigger = {"a": torch.zeros((2,)), "c": torch.zeros((3,))}
        with pytest.raises(ValueError, match="missing"):
            restore_checkpoint(path, bigger)
        with pytest.raises(ValueError, match="is \\(2,\\)"):
            restore_checkpoint(path, {"a": torch.zeros((3,))})


def test_straggler_backup_batch():
    def slow_gen():
        yield np.zeros(3)
        time.sleep(60)       # simulated stuck data worker
        yield np.ones(3)

    q = PrefetchQueue(slow_gen(), timeout_s=0.3,
                      backup_fn=lambda step: np.full(3, step, np.float64))
    a = q.get(0)
    b = q.get(1)           # producer is stuck -> backup batch
    np.testing.assert_array_equal(a, np.zeros(3))
    np.testing.assert_array_equal(b, np.full(3, 1.0))
    assert q.stats.timeouts == 1


@pytest.mark.parametrize("old,new,mp", [(512, 256, 16), (64, 128, 8),
                                        (8, 8, 1)])
def test_elastic_remesh_plan(old, new, mp):
    assert elastic_remesh_plan(old, new, mp) == \
        j_elastic_remesh_plan(old, new, mp)
    with pytest.raises(ValueError):
        elastic_remesh_plan(old, new + 1, 16)


@pytest.mark.parametrize("opt", ["adamw", "sgd", "adafactor"])
def test_optimizers_reduce_loss(opt):
    params, loss_fn, batch_fn = setup_lm()
    tcfg = TrainConfig(steps=12, optimizer=opt, peak_lr=5e-3, warmup=2,
                       log_every=3)
    r = train(loss_fn, params, batch_fn, tcfg, log_fn=quiet)
    assert r.losses[-1][1] < r.losses[0][1] + 0.05


def test_accumulation_matches_big_batch():
    params, loss_fn, _ = setup_lm()
    pipe = TokenPipeline(TokenPipelineConfig(vocab=64, seq_len=16,
                                             global_batch=8))
    batch = pipe.batch(0)
    t_one = TrainConfig(steps=4, peak_lr=1e-3, warmup=1)
    t_acc = TrainConfig(steps=4, peak_lr=1e-3, warmup=1, accum_steps=4)
    s0, m0 = make_train_step(loss_fn, t_one)(init_train_state(params, t_one),
                                             batch)
    s1, m1 = make_train_step(loss_fn, t_acc)(init_train_state(params, t_acc),
                                             batch)
    np.testing.assert_allclose(float(m0["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for k, a in s0.params.items():
        np.testing.assert_allclose(a.numpy(), s1.params[k].numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_quantize_error_feedback_identity():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    q, scale, new_res = compression.quantize(g, torch.zeros(64))
    deq = compression.dequantize(q, scale)
    # residual + dequantised = original (error feedback is exact)
    np.testing.assert_allclose((deq + new_res).numpy(), g.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float((deq - g).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_compressed_training_converges():
    """int8+EF gradients still train a toy regression to low loss."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    X = torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32))
    y = X @ torch.from_numpy(w_true)
    params = {"w": torch.zeros(8)}
    res = compression.init_residuals(params)

    def loss(p):
        return torch.mean((X @ p["w"] - y) ** 2)

    for _ in range(150):
        w = params["w"].requires_grad_(True)
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        codes, scales, res = compression.compress_tree(g, res)
        g_hat = compression.decompress_tree(codes, scales)
        params = {"w": params["w"].detach() - 0.1 * g_hat["w"]}
    assert float(loss(params)) < 1e-3
    np.testing.assert_allclose(params["w"].numpy(), w_true, atol=0.02)


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def run_main(main, argv) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().strip().splitlines()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_launcher_trains_smoke_configs_on_cpu(arch):
    lines = run_main(tlaunch.main, ["--arch", arch, "--steps", "8",
                                    "--device", "cpu"])
    assert lines[0].startswith(f"[train] arch={arch} family=lm params=")
    first, last = (float(x) for x in
                   lines[-1].split("loss ")[1].split(" (")[0].split(" -> "))
    assert last < first and "straggler timeouts: 0" in lines[-1]


def test_example_chaos_drill_on_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = run_main(mod.main, ["--device", "cpu"])
    assert "[train] resumed from step 20" in lines
    assert "[train] survived 1 injected failure(s)" in lines
    assert lines[-1].startswith("[train] loss ")


def test_launcher_refuses_unported_families_and_no_card(monkeypatch):
    """Without a card the default device raises (every family trains since
    item 13d; ``tests/test_torch_train_gnn.py`` runs the GNN and recsys
    archs)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen3-0.6b", "--steps", "2"])


def test_checkpoint_names_leaves_by_parameter_path():
    """A train state's leaves are named from the reference's parameter
    paths and the optimizer state's fields."""
    params, _, _ = setup_lm()
    state = init_train_state(params, TrainConfig())
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 4, state)
        with open(os.path.join(path, "manifest.json")) as f:
            names = {leaf["name"] for leaf in json.load(f)["leaves"]}
    assert {"params.blocks_0_attn_wq", "params.embed", "step",
            "opt_state.step", "opt_state.m.blocks_0_ln1",
            "opt_state.v.final_norm"} <= names
    assert len(names) == 3 * len(params) + 2
