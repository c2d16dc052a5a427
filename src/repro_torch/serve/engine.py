"""Continuous-batching serving engine for the LM tier, the port of
``repro/serve/engine.py``.

A fixed pool of ``max_batch`` slots decodes in lock-step (one decode step
per iteration, per-slot positions); a finished slot is refilled from the
request queue by prefilling the new prompt at B = 1 and scattering its
cache into the pool (slot-swap continuous batching; the pool is
preallocated at ``max_len``, so no paged KV is needed at this scale).

Greedy decoding takes the ``argmax``; sampling draws with
``torch.multinomial`` on the softmax from a ``torch.Generator`` seeded
with ``seed``, which cannot reproduce ``jax.random.categorical``'s draws
(ROADMAP.md §3 E).  The engine runs where the model's parameters live,
with autograd off.  Like the reference it decodes every slot each step,
idle ones too: with MoE layers an idle slot's token takes expert capacity,
so a request's tokens can depend on what the other slots hold.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import LMConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1             # -1: never stops early


@dataclasses.dataclass
class Completion:
    tokens: list
    prompt_len: int


class ServeEngine:
    def __init__(self, model: T.TransformerLM, cfg: LMConfig, *,
                 max_batch: int = 4, max_len: int = 256,
                 prompt_len: int = 32, compute_dtype=torch.float32,
                 greedy: bool = True, seed: int = 0):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.dtype = compute_dtype
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = T.make_cache(cfg, max_batch, max_len,
                                   dtype=compute_dtype, device=self.device)
        self.pos = np.zeros(max_batch, dtype=np.int64)
        self.active = np.zeros(max_batch, dtype=bool)
        self.last_tok = np.zeros(max_batch, dtype=np.int64)
        self.budget = np.zeros(max_batch, dtype=np.int32)
        self.eos = np.full(max_batch, -1, dtype=np.int32)
        self.out: list[list | None] = [None] * max_batch

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def _insert(self, slot: int, req: Request) -> None:
        prompt = np.asarray(req.prompt, dtype=np.int32)
        S = self.prompt_len
        if len(prompt) > S:
            prompt = prompt[-S:]
        pad = S - len(prompt)
        # left-pad by repeating the first token (harmless for a synthetic
        # LM); an empty prompt degenerates to a BOS/0-token prefill
        fill = prompt[0] if len(prompt) else np.int32(0)
        padded = np.concatenate([np.full(pad, fill, np.int32), prompt])
        logits, pc = T.prefill(self.model, self._tensor(
            padded[None, :].astype(np.int64)), max_len=self.max_len,
            compute_dtype=self.dtype)
        nxt = int(torch.argmax(logits[0]))
        # scatter the single-request cache into the pool at `slot`
        # (prefill used the same max_len, so cache lengths line up)
        for layer in range(self.cfg.n_layers):
            pool, one = self.caches[layer], pc[layer]
            for name in pool:
                assert pool[name].shape[1:] == one[name].shape[1:]
                pool[name][slot] = one[name][0]
        self.pos[slot] = S
        self.active[slot] = True
        self.last_tok[slot] = nxt
        self.budget[slot] = req.max_new_tokens - 1
        self.eos[slot] = req.eos_id
        self.out[slot] = list(prompt) + [nxt]

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=self.generator)[:, 0].cpu().numpy()

    @torch.no_grad()
    def run(self, requests: Sequence[Request]) -> list[Completion]:
        queue = list(requests)
        results: dict[int, Completion] = {}
        owner: dict[int, int] = {}
        next_rid = 0
        done = 0
        while done < len(requests):
            # refill free slots
            for slot in range(self.max_batch):
                if not self.active[slot] and queue:
                    req = queue.pop(0)
                    self._insert(slot, req)
                    owner[slot] = next_rid
                    next_rid += 1
            if not self.active.any():
                break
            logits, self.caches = T.decode_step(
                self.model, self.caches, self._tensor(self.last_tok[:, None]),
                self._tensor(self.pos), compute_dtype=self.dtype)
            nxt = self._next_tokens(logits)
            for slot in range(self.max_batch):
                if not self.active[slot]:
                    continue
                self.out[slot].append(int(nxt[slot]))
                self.pos[slot] += 1
                self.last_tok[slot] = nxt[slot]
                self.budget[slot] -= 1
                if (self.budget[slot] <= 0
                        or int(nxt[slot]) == int(self.eos[slot])):
                    rid = owner[slot]
                    results[rid] = Completion(tokens=self.out[slot],
                                              prompt_len=self.prompt_len)
                    self.active[slot] = False
                    done += 1
        return [results[i] for i in sorted(results)]
