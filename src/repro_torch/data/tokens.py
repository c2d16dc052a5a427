"""Deterministic synthetic LM token pipeline, a numpy copy of
``repro/data/tokens.py`` (its batches are the reference's, token for
token).

A fixed random Markov chain over the vocabulary generates structured
sequences (so cross-entropy actually decreases during training), seeded
per (shard, step), so fully deterministic and restart-safe: resuming at
step k regenerates exactly the batch-k stream, which checkpoint-restart
bit-exactness relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4        # out-degree of the Markov chain


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig, *, shard: int = 0,
                 num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        rng = np.random.default_rng(cfg.seed)
        # sparse deterministic transition structure
        self.next_tokens = rng.integers(
            0, cfg.vocab, size=(cfg.vocab, cfg.branching)).astype(np.int32)

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len) int32, deterministic in (step, shard)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.shard, 0xB1E57))
        toks = np.empty((self.local_batch, cfg.seq_len), dtype=np.int32)
        cur = rng.integers(0, cfg.vocab, size=self.local_batch).astype(np.int32)
        toks[:, 0] = cur
        branch = rng.integers(0, cfg.branching,
                              size=(self.local_batch, cfg.seq_len - 1))
        for t in range(1, cfg.seq_len):
            cur = self.next_tokens[cur, branch[:, t - 1]]
            toks[:, t] = cur
        return toks

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
