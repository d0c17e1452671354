"""Deterministic, shardable, resumable data pipeline (a copy of
repro.data.pipeline).

Synthetic LM streams with learnable structure (order-2 Markov chains with a
seeded transition table) so convergence experiments have signal, plus a
memory-mapped token-shard reader for real corpora. Iterator state (epoch,
cursor) is part of the checkpoint, so restart is exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class MarkovLM:
    """Order-2 Markov source: next ~ Cat(T[a, b]). Deterministic from seed."""

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.3):
        rng = np.random.default_rng(seed)
        v = min(vocab, 64)                       # latent alphabet
        self.vocab = vocab
        self.v = v
        logits = rng.gumbel(size=(v, v, v)) / concentration
        self.T = np.exp(logits - logits.max(-1, keepdims=True))
        self.T /= self.T.sum(-1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        out = np.zeros((batch, seq + 1), np.int64)
        out[:, 0] = rng.integers(0, self.v, batch)
        out[:, 1] = rng.integers(0, self.v, batch)
        for t in range(2, seq + 1):
            p = self.T[out[:, t - 2], out[:, t - 1]]
            cum = np.cumsum(p, -1)
            u = rng.random((batch, 1))
            out[:, t] = (u > cum).sum(-1)
        return out[:, :-1].astype(np.int32), out[:, 1:].astype(np.int32)


class MMapTokens:
    """Flat token file (np.int32) read as contiguous windows."""

    def __init__(self, path: str):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def window(self, start: int, batch: int, seq: int):
        n = batch * (seq + 1)
        start = start % max(len(self.tokens) - n, 1)
        w = np.asarray(self.tokens[start:start + n]).reshape(batch, seq + 1)
        return w[:, :-1].copy(), w[:, 1:].copy()


@dataclass
class LoaderState:
    step: int = 0
    epoch: int = 0


class ShardedLoader:
    """Per-virtual-worker stream: worker `shard` of `num_shards` sees a
    disjoint deterministic substream. Resumable via state_dict."""

    def __init__(self, source, batch: int, seq: int, shard: int,
                 num_shards: int, seed: int = 0):
        self.source = source
        self.batch, self.seq = batch, seq
        self.shard, self.num_shards = shard, num_shards
        self.seed = seed
        self.state = LoaderState()

    def next(self):
        s = self.state
        if isinstance(self.source, MarkovLM):
            rng = np.random.default_rng(
                (self.seed, self.shard, s.epoch, s.step))
            x, y = self.source.sample(rng, self.batch, self.seq)
        else:
            stride = self.batch * (self.seq + 1)
            start = (s.step * self.num_shards + self.shard) * stride
            x, y = self.source.window(start, self.batch, self.seq)
        s.step += 1
        return x, y

    def state_dict(self):
        return {"step": self.state.step, "epoch": self.state.epoch}

    def load_state_dict(self, sd):
        self.state = LoaderState(**sd)


def write_token_file(path: str, tokens: np.ndarray):
    tokens.astype(np.int32).tofile(path)
    return path
