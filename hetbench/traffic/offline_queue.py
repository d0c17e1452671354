"""Generator kind `offline_queue`: an offline batch of requests, every one
queued at t0, greedy, each with its own output length.

A mix of this kind names max_batch, prompt_len, gen, requests, block,
prompt_law, output_law and zipf_exponent. Prompt and output lengths are
each law's quantile grid of `block` points in a fixed order
(sampling.spread_lengths: the prompts bit-reversed, so any run of them
spreads over the law, the outputs in a fixed permutation), the same under
every seed; the seed draws the Zipf ids."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hetbench import sampling


@dataclass
class Req:
    rid: int
    prompt: np.ndarray          # int32 [prompt length]
    max_new_tokens: int


def _draw(mix: dict, vocab: int, seed: int, n: int, stream: int):
    g = sampling.rng(seed, stream)
    plen = sampling.spread_lengths(mix["prompt_law"], n, mix["block"])
    olen = sampling.spread_lengths(mix["output_law"], n, mix["block"],
                                   sampling.fixed_order)
    zipf = sampling.Zipf(vocab, mix["zipf_exponent"])
    ids = zipf.draw(g, int(plen.sum()))
    cut = np.concatenate([[0], np.cumsum(plen)])
    return [Req(i, ids[cut[i]:cut[i + 1]], int(olen[i])) for i in range(n)]


def make(mix: dict, cfg: dict, seed: int) -> list:
    """The queue of the measured run."""
    return _draw(mix, vocab_of(cfg), seed, int(mix["requests"]), 2)


def warmup(mix: dict, cfg: dict, seed: int) -> list:
    """Two admission groups of max_batch requests answering 2 tokens each:
    the prefill [max_batch, prompt_len] and decode [max_batch, 1] shapes of
    the cell, and no other."""
    reqs = _draw(mix, vocab_of(cfg), seed, 2 * int(mix["max_batch"]), 3)
    for r in reqs:
        r.max_new_tokens = 2
    return reqs


def vocab_of(cfg: dict) -> int:
    return int(cfg["port"]["fields"]["vocab_size"])
