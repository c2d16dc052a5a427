"""The port's continuous-batching LM server (``repro_torch.serve.
ServeEngine``), its launcher (``python -m repro_torch.launch.serve``) and
``examples/torch_serve_lm.py`` against the JAX reference.

The weights come from the reference's ``init_lm(PRNGKey(0), cfg)``
through ``load_reference_params``; at ``tests/test_serve_data.py``'s
smoke config the port's greedy served tokens equal the reference
``ServeEngine``'s on the same requests, and the reference's own serving
cases (``test_serve_engine_matches_standalone_decode``,
``test_serve_engine_empty_prompt``) run on the port.  The launcher and
the example run with ``--device cpu``; without it they take the card,
and with no card they raise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import LMConfig as JLMConfig
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.errors import ConfigError
from repro_torch.launch import serve as tlaunch
from repro_torch.models import LMConfig
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeEngine
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
           d_head=16, d_ff=64, vocab=64, window=16, local_global=(1, 1))


@pytest.fixture(scope="module")
def weights():
    """The reference's params and the port's model carrying them."""
    jcfg = JLMConfig(**CFG)
    params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    model = TT.load_reference_params(
        TT.init_lm(LMConfig(**CFG), device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, model


def requests(cls, n: int = 5):
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, 64, rng.integers(3, 9)),
                max_new_tokens=6) for _ in range(n)]


def test_served_tokens_equal_reference(weights):
    """Slot swaps, refills and per-slot positions: greedy tokens of 5
    requests through 3 slots equal the reference server's, token for
    token."""
    jcfg, params, model = weights
    want = JServeEngine(params, jcfg, max_batch=3, max_len=64,
                        prompt_len=8).run(requests(JRequest))
    got = ServeEngine(model, model.cfg, max_batch=3, max_len=64,
                      prompt_len=8).run(requests(Request))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert [int(x) for x in g.tokens] == [int(x) for x in w.tokens]
        assert g.prompt_len == w.prompt_len


def test_serve_engine_matches_standalone_decode(weights):
    _, _, model = weights
    eng = ServeEngine(model, model.cfg, max_batch=3, max_len=64,
                      prompt_len=8)
    reqs = requests(Request)
    outs = eng.run(reqs)
    assert len(outs) == 5
    prompt = np.asarray(reqs[0].prompt, np.int32)
    pad = 8 - len(prompt)
    padded = (np.concatenate([np.full(pad, prompt[0], np.int32), prompt])
              if pad > 0 else prompt[-8:])
    logits, caches = TT.prefill(model, torch.from_numpy(
        padded[None, :].astype(np.int64)), max_len=64,
        compute_dtype=torch.float32)
    toks = [int(torch.argmax(logits[0]))]
    pos = 8
    for _ in range(5):
        lg, caches = TT.decode_step(model, caches,
                                    torch.tensor([[toks[-1]]]), pos,
                                    compute_dtype=torch.float32)
        toks.append(int(torch.argmax(lg[0])))
        pos += 1
    assert outs[0].tokens[-6:] == toks


def test_serve_engine_empty_prompt(weights):
    """A zero-length prompt prefills as BOS/0 padding instead of crashing
    on ``prompt[0]``."""
    _, _, model = weights
    eng = ServeEngine(model, model.cfg, max_batch=2, max_len=32,
                      prompt_len=8)
    outs = eng.run([Request(prompt=np.array([], dtype=np.int32),
                            max_new_tokens=4),
                    Request(prompt=np.array([3, 5], dtype=np.int32),
                            max_new_tokens=4)])
    assert len(outs) == 2
    assert len(outs[0].tokens) == 4          # empty prompt: only generated
    assert all(0 <= t < 64 for t in outs[0].tokens)


def test_sampling_is_seeded(weights):
    """``greedy=False`` draws from the softmax with the engine's own
    generator: one seed, one sequence; tokens stay in the vocabulary."""
    _, _, model = weights
    runs = [[o.tokens for o in ServeEngine(
        model, model.cfg, max_batch=2, max_len=64, prompt_len=8,
        greedy=False, seed=seed).run(requests(Request, 3))]
        for seed in (1, 1, 2)]
    assert runs[0] == runs[1]
    assert all(0 <= int(t) < 64 for out in runs[2] for t in out)


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def run_main(fn, argv) -> tuple[list, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue()


def test_launcher_serves_on_cpu():
    outs, text = run_main(tlaunch.main, [
        "--arch", "qwen3-0.6b", "--requests", "5", "--max-new", "4",
        "--device", "cpu"])
    lines = text.strip().splitlines()
    assert lines[0].startswith("[serve] arch=qwen3-0.6b(smoke) served 5 "
                               "requests, 20 new tokens in ")
    assert lines[0].endswith("continuous batching over 4 slots)")
    assert len(outs) == 5 and all(len(o.tokens) >= 4 for o in outs)


def test_example_serves_on_cpu():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_serve_lm
    finally:
        sys.path.pop(0)
    outs, text = run_main(torch_serve_lm.main, ["--device", "cpu"])
    assert text.startswith("[serve] arch=gemma3-1b(smoke) served 10 "
                           "requests, 80 new tokens in ")
    assert len(outs) == 10


def test_launcher_without_a_card_raises(monkeypatch):
    """Without ``--device cpu`` the launcher takes the card; with no card
    it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        tlaunch.main(["--requests", "1"])


def test_engine_config_matches_reference():
    """The port's config dataclass has the reference's fields."""
    assert [f.name for f in dataclasses.fields(LMConfig)] == \
        [f.name for f in dataclasses.fields(JLMConfig)]
