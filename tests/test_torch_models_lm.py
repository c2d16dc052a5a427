"""The port's LM serving tier (``repro_torch.models``: ``layers``,
``transformer``; ``repro_torch.configs``) against the JAX reference.

The weights come from the reference's ``init_lm(PRNGKey(0), cfg)``,
carried into the port by ``load_reference_params``, so both packages
compute the same function.  At the reference's own smoke sizes
(``tests/test_models_lm.py``'s dense variants, B = 2, S = 32, V = 128, and
an ``mp_attn=True`` one), in float32 on the CPU, every module's output
equals the reference's within rtol and atol 3e-4: ``rms_norm``,
``apply_rope``, ``attend`` (windowed, slot-masked, and chunked at a small
``q_chunk``), ``apply_gqa``, ``apply_mlp``, ``forward``'s logits,
``prefill``'s logits and caches, and 4 ``decode_step``s.  The reference's
own invariants run on the port at its tolerances (3e-4 and 5e-4), with
``forward`` under ``torch.no_grad()`` as an inference caller runs it.
The registry holds the reference's ten archs, each config equal to its
reference.  The MoE, MLA and MTP variants are
``tests/test_torch_models_moe_mla.py``'s.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs as jlist_archs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as tconfigs
from repro_torch.errors import ConfigError
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from torch_one_thread import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
B, S, V = 2, 32, 128
TOL = dict(rtol=3e-4, atol=3e-4)
F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)

VARIANTS = {
    "gqa_qknorm": JL.LMConfig(name="t", n_layers=3, d_model=64, n_heads=4,
                              n_kv_heads=2, d_head=16, d_ff=128, vocab=V,
                              qk_norm=True),
    "swa": JL.LMConfig(name="t", n_layers=3, d_model=64, n_heads=4,
                       n_kv_heads=2, d_head=16, d_ff=128, vocab=V, window=8,
                       local_global=(1, 0), tie_embeddings=False),
    "local_global": JL.LMConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                                n_kv_heads=1, d_head=16, d_ff=128, vocab=V,
                                window=8, local_global=(2, 1)),
    "mp_attn": JL.LMConfig(name="t", n_layers=3, d_model=64, n_heads=4,
                           n_kv_heads=2, d_head=16, d_ff=128, vocab=V,
                           qk_norm=True, mp_attn=True),
}


def port_cfg(cfg):
    """The port's config of the same fields as a reference config."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = TL.MoEConfig(**dataclasses.asdict(cfg.moe))
    return TL.LMConfig(**fields)


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


_MODELS: dict = {}


def models(name: str):
    """(reference cfg, reference params, port model), one per variant."""
    if name not in _MODELS:
        cfg = VARIANTS[name]
        # mp_attn changes no parameter: share the reference's init
        base = dataclasses.replace(cfg, mp_attn=False)
        same = [v for v in _MODELS.values() if v[0] == base]
        params = same[0][1] if same else JT.init_lm(KEY, cfg)
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


def layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["blocks"][0])


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
def test_rms_norm_and_rope_equal_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 6, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    close(TL.rms_norm(t(x), t(w), 1e-6), JL.rms_norm(jnp.asarray(x),
                                                     jnp.asarray(w), 1e-6))
    pos = np.tile(np.arange(3, 9, dtype=np.int32), (B, 1))
    for theta in (10_000.0, 1_000_000.0):
        close(TL.apply_rope(t(x), t(pos), theta),
              JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("case", ["causal", "window", "k_valid", "chunked"])
def test_attend_equals_reference(case, mixed):
    """Causal, windowed, slot-masked (``k_valid``) and chunked attention
    (``Sq > q_chunk``, ``Sq % q_chunk == 0``, at ``q_chunk = 4``)."""
    rng = np.random.default_rng(2)
    Sq = 8
    q = rng.standard_normal((B, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((B, Sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, Sq, 2, 16)).astype(np.float32)
    pos = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    window = 3 if case in ("window", "chunked") else None
    k_valid = (rng.random((B, Sq)) < 0.8) | (np.arange(Sq) == 0) \
        if case == "k_valid" else None
    q_chunk = 4 if case == "chunked" else JL.Q_CHUNK
    want = JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(pos), jnp.asarray(pos),
                     None if window is None else jnp.int32(window),
                     None if k_valid is None else jnp.asarray(k_valid),
                     q_chunk=q_chunk, mixed=mixed)
    got = TL.attend(t(q), t(k), t(v), t(pos), t(pos), window,
                    None if k_valid is None else t(k_valid),
                    q_chunk=q_chunk, mixed=mixed)
    close(got, want)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gqa_and_mlp_equal_reference(name):
    cfg, params, model = models(name)
    p = layer0(params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    win = cfg.layer_window(0)
    want, _ = JL.apply_gqa(p["attn"], cfg, jnp.asarray(x), jnp.asarray(pos),
                           window=jnp.int32(0 if win is None else win))
    got, _ = TL.apply_gqa(model.blocks[0].attn, model.cfg, t(x), t(pos),
                          window=0 if win is None else win)
    close(got, want)
    close(TL.apply_mlp(model.blocks[0].ffn, t(x)),
          JL.apply_mlp(p["ffn"], jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_prefill_decode_equal_reference(name):
    """``forward``'s logits, ``prefill``'s logits and every layer's cache
    at S // 2, then 4 ``decode_step``s, each against the reference's."""
    cfg, params, model = models(name)
    toks = tokens_of(4)
    want, _ = JT.forward(params, cfg, jnp.asarray(toks), remat=False, **F32)
    got, _ = TT.forward(model, t(toks).long(), **T32)
    close(got, want)
    jl, jc = JT.prefill(params, cfg, jnp.asarray(toks[:, :S // 2]),
                        max_len=S, **F32)
    tl, tc = TT.prefill(model, t(toks[:, :S // 2]).long(), max_len=S, **T32)
    close(tl, jl)
    assert len(tc) == len(jc) == cfg.n_layers
    for a, b in zip(tc, jc):
        for name_ in ("k", "v"):
            assert tuple(a[name_].shape) == b[name_].shape
            close(a[name_], b[name_])
    for pos in range(S // 2, S // 2 + 4):
        jl, jc = JT.decode_step(params, cfg, jc,
                                jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.int32(pos), **F32)
        tl, tc = TT.decode_step(model, tc, t(toks[:, pos:pos + 1]).long(),
                                pos, **T32)
        close(tl, jl)


# ---------------------------------------------------------------------------
# the reference's own invariants, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gqa_qknorm", "local_global"])
def test_decode_matches_forward(name):
    _, _, model = models(name)
    toks = t(tokens_of(2)).long()
    with torch.no_grad():
        logits_full, _ = TT.forward(model, toks, **T32)
    lp, caches = TT.prefill(model, toks[:, :S // 2], max_len=S, **T32)
    close(lp, logits_full[:, S // 2 - 1].numpy(), rtol=3e-4, atol=3e-4)
    for pos in range(S // 2, S // 2 + 4):
        ld, caches = TT.decode_step(model, caches, toks[:, pos:pos + 1], pos,
                                    **T32)
        close(ld, logits_full[:, pos].numpy(), rtol=5e-4, atol=5e-4)


def test_window_rotation_long_decode():
    _, _, model = models("swa")
    toks = t(tokens_of(3)).long()
    with torch.no_grad():
        logits_full, _ = TT.forward(model, toks, **T32)
    _, caches = TT.prefill(model, toks[:, :4], max_len=S, **T32)
    for pos in range(4, 28):  # decode well past the window wraparound
        ld, caches = TT.decode_step(model, caches, toks[:, pos:pos + 1], pos,
                                    **T32)
        close(ld, logits_full[:, pos].numpy(), rtol=5e-4, atol=5e-4)


def test_per_slot_positions_decode():
    """Continuous batching: different positions per slot equal per-slot
    independent decodes."""
    _, _, model = models("gqa_qknorm")
    toks = t(tokens_of(5, (2, 16))).long()
    lens = [8, 5]
    caches_ind = [TT.prefill(model, toks[b:b + 1, :lens[b]], max_len=16,
                             **T32)[1] for b in range(2)]
    merged = [{k: torch.cat([lc0[k], lc1[k]], dim=0) for k in lc0}
              for lc0, lc1 in zip(*caches_ind)]
    tok = torch.stack([toks[0, lens[0]:lens[0] + 1],
                       toks[1, lens[1]:lens[1] + 1]])
    lg_b, _ = TT.decode_step(model, merged, tok, torch.tensor(lens), **T32)
    for b in range(2):
        lg_s, _ = TT.decode_step(model, caches_ind[b], tok[b:b + 1], lens[b],
                                 **T32)
        close(lg_b[b], lg_s[0].numpy(), rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# configs, refusals, loading
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-1b",
                                  "h2o-danube-1.8b", "olmoe-1b-7b",
                                  "deepseek-v3-671b"])
def test_ported_archs_equal_reference(arch):
    got, want = tconfigs.get_arch(arch), jget_arch(arch)
    assert got.family == want.family == "lm"
    for field in ("model_cfg", "smoke_cfg"):
        assert dataclasses.asdict(getattr(got, field)) == \
            dataclasses.asdict(getattr(want, field)), field
    assert got.shapes == {k: tconfigs.LMShape(**dataclasses.asdict(v))
                          for k, v in want.shapes.items()}
    assert arch in tconfigs.list_archs()


@pytest.mark.parametrize("arch", ["gin-tu", "dimenet", "nequip", "egnn",
                                  "fm"])
def test_gnn_and_recsys_archs_equal_reference(arch):
    got, want = tconfigs.get_arch(arch), jget_arch(arch)
    assert (got.family, got.gnn_kind) == (want.family, want.gnn_kind)
    for field in ("model_cfg", "smoke_cfg"):
        g, w = getattr(got, field), getattr(want, field)
        assert type(g).__name__ == type(w).__name__, field
        assert dataclasses.asdict(g) == dataclasses.asdict(w), field
    shape_cls = tconfigs.GNNShape if got.family == "gnn" \
        else tconfigs.RecShape
    assert got.shapes == {k: shape_cls(**dataclasses.asdict(v))
                          for k, v in want.shapes.items()}
    assert (got.param_rules, got.notes) == (want.param_rules, want.notes)


def test_registry_holds_all_ten_archs():
    """Every architecture of the reference, in its order; an unknown id
    is the reference's ``KeyError``."""
    assert tconfigs.list_archs() == jlist_archs()
    assert len(tconfigs.list_archs()) == 10
    assert [a.id for a in tconfigs.all_archs()] == jlist_archs()
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("no-such-arch")


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_load_reference_params_rejects_mismatch(fault):
    cfg, params, _ = models("swa")
    tree = np_tree(params)
    if fault == "missing":
        del tree["head"]
    elif fault == "extra":
        tree["blocks"][0]["attn"]["q_norm"] = np.zeros((3, 16), np.float32)
    elif fault == "shape":
        tree["final_norm"] = np.zeros(cfg.d_model + 1, np.float32)
    else:
        tree["embed"] = tree["embed"].astype(np.float64)
    with pytest.raises(ConfigError):
        TT.load_reference_params(TT.init_lm(port_cfg(cfg), device="cpu"),
                                 tree)


def test_init_lm_is_seeded_and_truncated():
    """Weights come from the explicit generator: the same seed gives the
    same model, and ``dense_init`` stays inside ±2σ / √fan_in."""
    cfg = port_cfg(VARIANTS["gqa_qknorm"])
    a = TT.init_lm(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = TT.init_lm(cfg, torch.Generator().manual_seed(7), device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    bound = 2.0 / np.sqrt(cfg.d_model)
    assert float(a.embed.abs().max()) <= bound + 1e-6
    assert float(a.blocks[0].attn.wq.abs().max()) <= bound + 1e-6


def test_lm_entry_points_take_the_card_or_raise(monkeypatch):
    """With no device the model and its caches go on the card; with no
    card that is a ``ConfigError``, never a quiet CPU run.  A generator on
    another device than the model's is refused."""
    cfg = port_cfg(VARIANTS["gqa_qknorm"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: TT.init_lm(cfg),
                  lambda: TT.init_lm(cfg, torch.Generator()),
                  lambda: TT.TransformerLM(cfg, torch.Generator()),
                  lambda: TT.make_cache(cfg, 1, 8)):
        with pytest.raises(ConfigError, match="no CUDA device"):
            build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ConfigError, match="generator is on cpu"):
        TT.init_lm(cfg, torch.Generator())
    assert TT.make_cache(cfg, 1, 8, device="cpu")[0]["k"].device.type == \
        "cpu"


@pytest.mark.parametrize("entry", ["forward", "prefill", "decode_step"])
def test_float32_matmuls_turn_tf32_off_inside(monkeypatch, entry):
    """In float32 mode every layer runs with TF32 off even where the
    caller turned it on, and the caller's setting is back afterwards;
    bfloat16 mode and an unset flag leave it alone."""
    _, _, model = models("gqa_qknorm")
    seen = []
    apply_layer = TT.apply_layer

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return apply_layer(*args, **kwargs)

    monkeypatch.setattr(TT, "apply_layer", spy)
    toks = t(tokens_of(5)).long()
    _, caches = TT.prefill(model, toks[:, :4], max_len=S, **T32)

    def run(**kw):
        if entry == "forward":
            return TT.forward(model, toks, **kw)
        if entry == "prefill":
            return TT.prefill(model, toks[:, :4], max_len=S, **kw)
        return TT.decode_step(model, caches, toks[:, 4:5], 4, **kw)

    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", flag)
        seen.clear()
        run(**T32)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen.clear()
    run(compute_dtype=torch.bfloat16)
    assert seen and all(seen)
