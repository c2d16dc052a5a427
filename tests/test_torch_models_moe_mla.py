"""The port's MoE, MLA and MTP (``repro_torch.models``, ROADMAP.md queue 1
item 13b) against the JAX reference.

The weights come from the reference's ``init_lm(PRNGKey(0), cfg)`` (or
``init_moe``/``init_mla`` for one layer), carried into the port by
``load_reference_params``, so both packages compute the same function.
In float32 on the CPU:

* ``apply_moe`` under both routers, one group and two, at a capacity
  factor that drops and one that does not: the same routes (the
  reference's ``top_k``, caught as it runs), the same keeps and slots
  (the reference's cumulative-count formula over those routes), outputs
  within rtol and atol 3e-4; ``apply_mla`` likewise;
* ``forward``, ``prefill`` (logits and latent caches), 4 ``decode_step``s
  and ``mtp_hidden`` for the reference's ``moe`` and ``mla_ds3_mtp``
  variants (``tests/test_models_lm.py``), and decode at a factor that
  drops;
* the reference's own ``test_decode_matches_forward`` invariants on the
  port at its tolerances (3e-4, 5e-4);
* ``ServeEngine`` over OLMoE's smoke model at the published factor 1.25:
  the served tokens equal the reference engine's;
* ``lm_loss`` within 3e-4 and its gradients leaf by leaf against
  ``jax.grad`` within rtol 1e-4 and atol 1e-5, with and without remat;
* the serving launcher runs both archs' smoke configs with
  ``--device cpu``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.errors import ConfigError
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.loop import value_and_grad
from torch_one_thread import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
B, S, V = 2, 32, 128
TOL = dict(rtol=3e-4, atol=3e-4)
F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)

VARIANTS = {
    "moe": JL.LMConfig(name="t", n_layers=3, d_model=64, n_heads=4,
                       n_kv_heads=4, d_head=16, d_ff=128, vocab=V,
                       moe=JL.MoEConfig(n_experts=8, top_k=2, d_expert=32,
                                        capacity_factor=16.0)),
    "mla_ds3_mtp": JL.LMConfig(
        name="t", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=32, d_ff=128, vocab=V, attn="mla", q_lora_rank=48,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe=JL.MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                         router="sigmoid_ds3", capacity_factor=16.0),
        n_dense_layers=2, dense_d_ff=96, mtp=True),
}
# the reference's model functions, compiled once a config (its eager
# layer scans retrace every call)
JINIT = jax.jit(JT.init_lm, static_argnums=(1,))
JFORWARD = jax.jit(JT.forward, static_argnums=(1,),
                   static_argnames=("compute_dtype", "remat"))
JPREFILL = jax.jit(JT.prefill, static_argnums=(1,),
                   static_argnames=("compute_dtype", "max_len"))
JDECODE = jax.jit(JT.decode_step, static_argnums=(1,),
                  static_argnames=("compute_dtype",))
# the moe variant at a factor that drops (decode's C is 1 at B = 2)
VARIANTS["moe_drops"] = dataclasses.replace(
    VARIANTS["moe"], moe=dataclasses.replace(VARIANTS["moe"].moe,
                                             capacity_factor=1.25))


def port_cfg(cfg):
    """The port's config of the same fields as a reference config."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = TL.MoEConfig(**dataclasses.asdict(cfg.moe))
    return TL.LMConfig(**fields)


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


_MODELS: dict = {}


def models(name: str):
    """(reference cfg, reference params, port model), one per variant; the
    dropping variant shares the moe variant's weights."""
    if name not in _MODELS:
        cfg = VARIANTS[name]
        params = models("moe")[1] if name == "moe_drops" else \
            JINIT(KEY, cfg)
        model = TT.load_reference_params(
            TT.init_lm(port_cfg(cfg), device="cpu"), np_tree(params))
        _MODELS[name] = (cfg, params, model)
    return _MODELS[name]


def tokens_of(seed: int, shape=(B, S)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def load_module(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a reference layer's pytree into the port's module of it."""
    flat = TT.reference_paths(np_tree(tree))
    names = dict(module.named_parameters())
    assert sorted(flat) == sorted(n.replace(".", "/") for n in names)
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(t(flat[name.replace(".", "/")]))
    return module


def reference_slots(top_idx: np.ndarray, E: int, C: int):
    """The reference's slot formula (``layers.py``'s cumulative count over
    the flattened (token, k) order) over its own routes."""
    G, Tg, K = top_idx.shape
    onehot = np.eye(E, dtype=np.int64)[top_idx]
    pos = ((np.cumsum(onehot.reshape(G, Tg * K, E), axis=1) - 1
            ).reshape(G, Tg, K, E) * onehot).sum(-1)
    return pos, pos < C


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factor", [1.0, 16.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("router", ["softmax", "sigmoid_ds3"])
def test_apply_moe_equals_reference(monkeypatch, router, groups, factor):
    """Routes equal the reference's (its ``top_k`` caught as it runs),
    keeps and slots its formula's, drops included, and the outputs within
    3e-4."""
    mc = JL.MoEConfig(n_experts=8, top_k=2, d_expert=16,
                      n_shared=1 if router == "sigmoid_ds3" else 0,
                      router=router, capacity_factor=factor,
                      routed_scale=2.5 if router == "sigmoid_ds3" else 1.0)
    cfg = JL.LMConfig(name="t", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_head=16, d_ff=64, vocab=V, moe=mc)
    tree = JL.init_moe(KEY, cfg)
    if router == "sigmoid_ds3":  # a bias that changes some choices
        tree["router_bias"] = jnp.asarray(np.random.default_rng(7).normal(
            0, 0.05, mc.n_experts).astype(np.float32))
    pcfg = port_cfg(cfg)
    moe = load_module(TL.MoE(pcfg, torch.Generator(), "cpu"), tree)
    x = np.random.default_rng(8).standard_normal((2, 12, 32)).astype(
        np.float32)
    seen = []
    real_top_k = jax.lax.top_k

    def spy(v, k):
        out = real_top_k(v, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    want = JL.apply_moe(tree, cfg, jnp.asarray(x), n_groups=groups)
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    got = TL.apply_moe(moe, pcfg, t(x), n_groups=groups)
    routed = TL.moe_route(moe, pcfg, t(x).reshape(groups, -1, 32))
    [want_idx] = seen
    np.testing.assert_array_equal(routed.top_idx.numpy(), want_idx)
    C = TL.moe_capacity(pcfg, 24 // groups)
    assert routed.capacity == C
    pos, keep = reference_slots(want_idx, mc.n_experts, C)
    np.testing.assert_array_equal(routed.keep.numpy(), keep)
    np.testing.assert_array_equal(routed.pos.numpy(), pos)
    assert keep.all() == (factor == 16.0)     # the dropping case drops
    close(got, want)


def test_top_k_takes_jax_order_on_ties():
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    for k in (1, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TL.top_k(t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_apply_mla_equals_reference():
    """The low-rank query, the normed latent and the one shared RoPE key
    broadcast to every head, attention scaled by the q dim (24 here) and
    values of ``v_head_dim`` 16: self-attention with the captured latent,
    then a decode callback over a cache."""
    cfg, params, model = models("mla_ds3_mtp")
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"][0])["attn"]
    attn = model.blocks[0].attn
    x = np.random.default_rng(3).standard_normal((B, 8, 64)).astype(
        np.float32)
    pos = np.tile(np.arange(8, dtype=np.int32), (B, 1))
    want, (wc, wr) = JL.apply_mla(p, cfg, jnp.asarray(x), jnp.asarray(pos),
                                  window=jnp.int32(0), capture_kv=True)
    got, (gc, gr) = TL.apply_mla(attn, model.cfg, t(x), t(pos), window=0,
                                 capture_kv=True)
    close(got, want)
    close(gc, wc)
    close(gr, wr)
    assert tuple(gr.shape) == (B, 8, 1, cfg.qk_rope_dim)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["moe", "mla_ds3_mtp", "moe_drops"])
def test_forward_prefill_decode_equal_reference(name):
    """``forward``'s logits, ``prefill``'s logits and every layer's cache
    (``k``/``v`` or the latent ``c_kv``/``k_rope``) at S // 2, then 4
    ``decode_step``s, each against the reference's; at the dropping
    factor each decode step routes B = 2 tokens into one slot an
    expert."""
    cfg, params, model = models(name)
    toks = tokens_of(4)
    want, _ = JFORWARD(params, cfg, jnp.asarray(toks), remat=False, **F32)
    with torch.no_grad():
        got, _ = TT.forward(model, t(toks).long(), **T32)
    close(got, want)
    jl, jc = JPREFILL(params, cfg, jnp.asarray(toks[:, :S // 2]),
                        max_len=S, **F32)
    tl, tc = TT.prefill(model, t(toks[:, :S // 2]).long(), max_len=S, **T32)
    close(tl, jl)
    assert len(tc) == len(jc) == cfg.n_layers
    for a, b in zip(tc, jc):
        assert sorted(a) == sorted(b)
        for key in a:
            assert tuple(a[key].shape) == b[key].shape
            close(a[key], b[key])
    for pos in range(S // 2, S // 2 + 4):
        jl, jc = JDECODE(params, cfg, jc,
                                jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.int32(pos), **F32)
        tl, tc = TT.decode_step(model, tc, t(toks[:, pos:pos + 1]).long(),
                                pos, **T32)
        close(tl, jl)


def test_mtp_hidden_equals_reference():
    cfg, params, model = models("mla_ds3_mtp")
    toks = tokens_of(6)
    _, h = JFORWARD(params, cfg, jnp.asarray(toks), remat=False, **F32)
    want = JT.mtp_hidden(params, cfg, h, jnp.asarray(toks), **F32)
    with torch.no_grad():
        _, th = TT.forward(model, t(toks).long(), **T32)
        got = TT.mtp_hidden(model, th, t(toks).long(), **T32)
    assert tuple(got.shape) == (B, S - 1, cfg.d_model)
    close(got, want)


@pytest.mark.parametrize("name", ["moe", "mla_ds3_mtp"])
def test_decode_matches_forward(name):
    """The reference's own invariant, on the port."""
    _, _, model = models(name)
    toks = t(tokens_of(2)).long()
    with torch.no_grad():
        logits_full, _ = TT.forward(model, toks, **T32)
    lp, caches = TT.prefill(model, toks[:, :S // 2], max_len=S, **T32)
    close(lp, logits_full[:, S // 2 - 1], rtol=3e-4, atol=3e-4)
    for pos in range(S // 2, S // 2 + 4):
        ld, caches = TT.decode_step(model, caches, toks[:, pos:pos + 1], pos,
                                    **T32)
        close(ld, logits_full[:, pos], rtol=5e-4, atol=5e-4)


def test_capacity_view_shares_parameters():
    """``with_capacity_factor`` routes with the new factor over the same
    tensors; the model keeps its own config."""
    cfg, _, model = models("moe_drops")
    view = TT.with_capacity_factor(model, 16.0)
    assert model.cfg.moe.capacity_factor == 1.25
    assert view.cfg.moe.capacity_factor == 16.0
    for (na, pa), (nb, pb) in zip(model.named_parameters(),
                                  view.named_parameters()):
        assert na == nb and pa is pb
    _, _, wide = models("moe")
    toks = t(tokens_of(9)).long()
    with torch.no_grad():
        np.testing.assert_array_equal(
            TT.forward(view, toks, **T32)[0].numpy(),
            TT.forward(wide, toks, **T32)[0].numpy())
    with pytest.raises(ConfigError, match="no MoE"):
        TT.with_capacity_factor(TT.init_lm(dataclasses.replace(
            model.cfg, moe=None), device="cpu"), 8.0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_served_tokens_equal_reference_at_published_factor():
    """OLMoE's smoke config at its published capacity factor (1.25): 5
    requests through 3 slots, every slot decoded each step (idle ones
    too, as the reference does), so routes and drops depend on the other
    slots; the greedy tokens equal the reference server's."""
    jcfg = jget_arch("olmoe-1b-7b").smoke_cfg
    assert jcfg.moe.capacity_factor == 1.25
    params = JINIT(KEY, jcfg)
    model = TT.load_reference_params(
        TT.init_lm(port_cfg(jcfg), device="cpu"), np_tree(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, rng.integers(3, 9))
               for _ in range(5)]
    want = JServeEngine(params, jcfg, max_batch=3, max_len=64,
                        prompt_len=8).run(
        [JRequest(prompt=p, max_new_tokens=6) for p in prompts])
    got = ServeEngine(model, model.cfg, max_batch=3, max_len=64,
                      prompt_len=8).run(
        [Request(prompt=p, max_new_tokens=6) for p in prompts])
    assert [[int(x) for x in g.tokens] for g in got] == \
        [[int(x) for x in w.tokens] for w in want]


# ---------------------------------------------------------------------------
# training: the loss and its gradients
# ---------------------------------------------------------------------------
_GRADS: dict = {}


def reference_loss_and_grads(name: str, toks: np.ndarray):
    if name not in _GRADS:
        cfg, params, _ = models(name)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, cfg, jnp.asarray(toks), remat=False,
                                 **F32)))(params)
        _GRADS[name] = (float(loss), TT.reference_paths(np_tree(grads)))
    return _GRADS[name]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", ["moe", "mla_ds3_mtp"])
def test_lm_loss_and_grads_equal_reference(name, remat):
    """The loss (next-token cross-entropy, plus 0.3 times the MTP head's)
    within 3e-4, every gradient leaf within rtol 1e-4 and atol 1e-5 of
    ``jax.grad``'s; the DeepSeek router's bias gets a zero gradient."""
    cfg, _, model = models(name)
    toks = tokens_of(11)
    want_loss, want = reference_loss_and_grads(name, toks)
    leaves = TT.reference_leaves(model)
    assert sorted(leaves) == sorted(want)
    loss, grads = value_and_grad(
        lambda p, b: TT.lm_loss(TT.bind(model, p), b, remat=remat, **T32),
        leaves, t(toks).long())
    np.testing.assert_allclose(float(loss), want_loss, rtol=3e-4, atol=3e-4)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-5, err_msg=path)
    if cfg.moe.router == "sigmoid_ds3":
        assert not grads["blocks/1/ffn/router_bias"].any()


def test_chunked_nll_equals_reference():
    """Streaming cross-entropy over chunks of 16 with a remainder chunk,
    against the reference's and the direct log-softmax."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, 45, 64)).astype(np.float32)
    head = rng.standard_normal((64, V)).astype(np.float32) * 0.1
    tg = rng.integers(0, V, (B, 45))
    want = JT._chunked_nll(jnp.asarray(x), jnp.asarray(head),
                           jnp.asarray(tg), chunk=16)
    got = TT._chunked_nll(t(x), t(head), t(tg), chunk=16)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    lp = torch.log_softmax(t(x) @ t(head), dim=-1)
    direct = -torch.take_along_dim(lp, t(tg)[..., None], dim=-1).mean()
    np.testing.assert_allclose(float(got), float(direct), rtol=1e-5)


def test_leaves_round_trip_and_bind_checks():
    """``reference_leaves`` is the reference's pytree, leaf for leaf;
    ``bind`` refuses leaves that do not match the model."""
    _, params, model = models("mla_ds3_mtp")
    leaves = TT.reference_leaves(model)
    ref = TT.reference_paths(np_tree(params))
    assert sorted(leaves) == sorted(ref)
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(leaf.numpy(), ref[path])
    assert TT.param_paths(model)["blocks.3.ffn.w_gate"] == \
        ("blocks/1/ffn/w_gate", 1)
    assert TT.param_paths(model)["mtp.block.attn.wq_a"] == \
        ("mtp/block/attn/wq_a", None)
    del leaves["mtp/proj"]
    with pytest.raises(ConfigError, match="mtp/proj"):
        TT.bind(model, leaves)


def test_moe_and_mla_entry_points_take_the_card_or_raise(monkeypatch):
    """Without ``device=`` an MoE or MLA model and its caches go on the
    card, and with no card that is a ``ConfigError``; the MLA caches are
    the latent's shapes."""
    cfg = port_cfg(VARIANTS["mla_ds3_mtp"])
    caches = TT.make_cache(cfg, 3, 10, device="cpu")
    assert {k: tuple(v.shape) for k, v in caches[0].items()} == {
        "c_kv": (3, 10, 32), "k_rope": (3, 10, 1, 8)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: TT.init_lm(cfg), lambda: TT.make_cache(cfg, 1, 8),
                  lambda: TT.init_lm(port_cfg(VARIANTS["moe"]))):
        with pytest.raises(ConfigError, match="no CUDA device"):
            build()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_launcher_serves_moe_and_mla_smoke_configs_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``
    serves the arch's smoke config, as the reference's launcher does."""
    import contextlib
    import io
    from repro_torch.launch import serve as tlaunch
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        outs = tlaunch.main(["--arch", arch, "--requests", "5",
                             "--max-new", "4", "--device", "cpu"])
    assert out.getvalue().startswith(
        f"[serve] arch={arch}(smoke) served 5 requests, 20 new tokens in ")
    assert len(outs) == 5 and all(len(o.tokens) >= 4 for o in outs)
