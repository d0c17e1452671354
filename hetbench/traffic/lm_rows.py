"""Generator kind `lm_rows`: training rows of Zipf token ids.

A mix of this kind names rows_per_wave, seq and zipf_exponent. Wave w's
rows come from the stream keyed by (seed, w): seq + 1 ids a row, the
inputs its first seq and the labels its last seq (next-token targets).
Every row of every wave differs."""
from __future__ import annotations

from hetbench import sampling


class Source:
    """The rows as the port's ShardedLoader reads a token source:
    window(start, batch, seq) -> (inputs, labels) int32 [batch, seq]. The
    loader's `start` is step * stride (one worker), so the wave index is
    start // stride."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.seed = mix, int(seed)
        self.zipf = sampling.Zipf(vocab, mix["zipf_exponent"])

    def wave(self, w: int):
        b, s = self.mix["rows_per_wave"], self.mix["seq"]
        ids = self.zipf.draw(sampling.rng(self.seed, 1, w), (b, s + 1))
        return ids[:, :-1].copy(), ids[:, 1:].copy()

    def window(self, start: int, batch: int, seq: int):
        b, s = self.mix["rows_per_wave"], self.mix["seq"]
        if (batch, seq) != (b, s):
            raise ValueError(f"the loader asks for [{batch}, {seq}] rows; "
                             f"the mix gives [{b}, {s}]")
        return self.wave(start // (b * (s + 1)))


def make(mix: dict, cfg: dict, seed: int) -> Source:
    return Source(mix, vocab_of(cfg), seed)


def vocab_of(cfg: dict) -> int:
    return int(cfg["port"]["fields"]["vocab_size"])


def tokens_per_wave(mix: dict) -> int:
    return int(mix["rows_per_wave"]) * int(mix["seq"])

