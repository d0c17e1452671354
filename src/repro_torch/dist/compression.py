"""Gradient codecs for the wave-delta push path (paper Section 5 variant; a
copy of repro.dist.compression).

Two codecs, both operating on flat float32 vectors (one per PS leaf):

  top-k + error feedback — send the k largest-magnitude entries, accumulate
    the rest into a per-key residual that is re-injected next wave. The
    residual makes the scheme mass-conserving: over any horizon,
    sum(sent) + residual == sum(true gradients) exactly.
  int8 stochastic rounding — dense 1 byte/entry with an unbiased rounding
    rule (E[q * scale] == x), the classic low-precision DP codec.

The compressor API is (idx, vals) pairs so the parameter server can apply
sparse updates in place: flat[idx] += vals.
"""
from __future__ import annotations

import threading

import numpy as np


# -- top-k sparsification -------------------------------------------------

def topk_compress(flat: np.ndarray, ratio: float):
    """Keep the ceil(ratio * n) largest-|x| entries of a flat vector.

    Returns (idx, vals) with idx sorted ascending (deterministic given the
    input; ties broken by argpartition order).
    """
    flat = np.asarray(flat, np.float32).ravel()
    n = flat.size
    k = max(1, min(n, int(round(ratio * n))))
    if k >= n:
        idx = np.arange(n, dtype=np.int64)
        return idx, flat.copy()
    idx = np.argpartition(np.abs(flat), n - k)[n - k:]
    idx = np.sort(idx).astype(np.int64)
    return idx, flat[idx].copy()


def topk_decompress(idx: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, np.float32)
    out[np.asarray(idx, np.int64)] = np.asarray(vals, np.float32)
    return out


class ErrorFeedbackCompressor:
    """Top-k with per-key residual accumulation (error feedback / EF-SGD).

    Keys are caller-chosen (the PS uses "{worker}/{leaf}") so each worker x
    leaf stream keeps its own residual and compression is stateless across
    streams.
    """

    def __init__(self, ratio: float):
        assert 0.0 < ratio <= 1.0, ratio
        self.ratio = float(ratio)
        self._residual: dict[str, np.ndarray] = {}

    def compress(self, key: str, flat: np.ndarray):
        flat = np.asarray(flat, np.float32).ravel()
        resid = self._residual.get(key)
        if resid is None or resid.size != flat.size:
            resid = np.zeros(flat.size, np.float32)
        acc = flat + resid
        idx, vals = topk_compress(acc, self.ratio)
        new_resid = acc.copy()
        new_resid[idx] = 0.0
        self._residual[key] = new_resid
        return idx, vals

    def wire_bytes(self, idx: np.ndarray, vals: np.ndarray) -> int:
        """int32 index + float32 value per kept entry."""
        return int(idx.size) * 4 + int(np.asarray(vals).nbytes)


# -- int8 stochastic rounding --------------------------------------------

class Int8StochasticQuantizer:
    """Dense int8 codec with unbiased stochastic rounding.

    q = floor(x / scale + u), u ~ U[0, 1), scale = max|x| / 127, so
    E[q * scale] = x. Decoded values are returned dense ((arange, vals))
    to satisfy the same apply-by-index contract as the sparse codec;
    wire_bytes charges 1 byte/entry + the float32 scale.
    """

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        # np.random.Generator is not thread-safe; the PS calls compress from
        # every worker thread concurrently
        self._rng_lock = threading.Lock()

    def quantize(self, flat: np.ndarray):
        flat = np.asarray(flat, np.float32).ravel()
        amax = float(np.max(np.abs(flat))) if flat.size else 0.0
        if amax == 0.0:
            return np.zeros(flat.size, np.int8), 0.0
        scale = amax / 127.0
        with self._rng_lock:
            u = self._rng.random(flat.size, np.float32)
        q = np.floor(flat / scale + u)
        return np.clip(q, -127, 127).astype(np.int8), scale

    @staticmethod
    def dequantize(q: np.ndarray, scale: float) -> np.ndarray:
        return q.astype(np.float32) * np.float32(scale)

    def compress(self, key: str, flat: np.ndarray):
        q, scale = self.quantize(flat)
        idx = np.arange(q.size, dtype=np.int64)
        return idx, self.dequantize(q, scale)

    def wire_bytes(self, idx: np.ndarray, vals: np.ndarray) -> int:
        return int(np.asarray(vals).size) * 1 + 4


def make_codec(spec, seed: int = 0):
    """Parse a codec spec: None/'none', 'topk:<ratio>', a bare float (ratio),
    or 'int8'. Returns a codec object or None."""
    if spec is None:
        return None
    if isinstance(spec, (int, float)):
        return ErrorFeedbackCompressor(float(spec))
    s = str(spec).strip().lower()
    if s in ("", "none", "off"):
        return None
    if s == "int8":
        return Int8StochasticQuantizer(seed)
    if s.startswith("topk:"):
        return ErrorFeedbackCompressor(float(s.split(":", 1)[1]))
    try:
        return ErrorFeedbackCompressor(float(s))
    except ValueError:
        raise ValueError(f"unknown codec spec: {spec!r}") from None
