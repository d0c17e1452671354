"""Draws shared by the traffic generators: lengths on a fixed quantile grid
of their law, in one fixed order whatever the seed, and Zipf token ids
over the whole vocabulary drawn from the seed."""
from __future__ import annotations

import math

import numpy as np


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator keyed by the run seed and stream keys."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1),
                                  *(int(k) for k in keys)])


def quantiles(law: dict, n: int) -> np.ndarray:
    """n lengths at the midpoint quantiles (i + 0.5) / n of `law`
    ({"law": "uniform" | "loguniform", "lo", "hi"}), as integers."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(law["lo"]), float(law["hi"])
    if law["law"] == "uniform":
        x = lo + q * (hi - lo)
    elif law["law"] == "loguniform":
        x = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length law {law['law']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def spread_order(block: int) -> np.ndarray:
    """A fixed order of 0..block-1 (block a power of two) whose every
    prefix spreads over the whole range: the bit-reversed indices."""
    bits = block.bit_length() - 1
    if block != 1 << bits:
        raise ValueError("block must be a power of two")
    return np.array([int(f"{k:0{bits}b}"[::-1], 2) if bits else 0
                     for k in range(block)])


def fixed_order(block: int) -> np.ndarray:
    """Another fixed order of 0..block-1, a permutation keyed by the block
    size alone: pairs each prompt length with an output length that does
    not follow it."""
    return np.random.default_rng(block).permutation(block)


def spread_lengths(law: dict, n: int, block: int, order=spread_order
                   ) -> np.ndarray:
    """n lengths: `law`'s quantile grid of `block` points in `order`,
    block after block, the same in every run: the work a window sees does
    not change with the seed."""
    return np.resize(quantiles(law, block)[order(block)], n)


class Zipf:
    """Token ids by a Zipf law of exponent s over all `vocab` ids: rank r
    has weight r^-s, and ranks map to ids through a permutation fixed by
    the vocabulary size (the same frequent ids under every seed)."""

    def __init__(self, vocab: int, s: float):
        w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(s)
        self.cdf = np.cumsum(w) / w.sum()
        self.ids = np.random.default_rng(vocab).permutation(vocab)

    def draw(self, g: np.random.Generator, shape) -> np.ndarray:
        r = np.searchsorted(self.cdf, g.random(shape), side="right")
        return self.ids[np.minimum(r, len(self.ids) - 1)].astype(np.int32)
