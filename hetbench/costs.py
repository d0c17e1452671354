"""Operations and bytes of each kernel's work that the traffic asks for,
worked out from the configuration's sizes and the real tokens (no
padding, no idle rows, no capacity slack, no masked blocks), and the
H100's published peaks. A whole model's FLOPs are its family's
(families/<family>.py). These are the benchmark's own counts: they do
not call the port's cost functions."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak, nbytes / HBM_BYTES_S)


def decode_paged(z, lens, elt=2):
    """flash_decode_paged, one layer: each live row attends over its
    `lens` positions, K/V read once, q in and out once."""
    H, KV, hd = z["H"], z["KV"], z["hd"]
    n, tot = len(lens), float(sum(lens))
    return 4.0 * H * hd * tot, elt * (2.0 * KV * hd * tot + 2.0 * H * hd * n)


def attention_prefill(z, lens, elt=2):
    """flash_attention_fwd, one layer: causal attention over each real
    prompt of length L (L (L + 1) / 2 pairs), q, k, v, o once."""
    H, KV, hd = z["H"], z["KV"], z["hd"]
    pairs = float(sum(L * (L + 1) // 2 for L in lens))
    return 4.0 * H * hd * pairs, elt * (2.0 * H + 2.0 * KV) * hd * float(sum(lens))


def expert_gemms(z, tokens: int, elt=2):
    """grouped_matmul, one layer's two calls, [(flops, bytes)] each: tokens
    x top_k choices through w_in [d, 2 ff], then w_out [ff, d]; every
    expert's weights read once, the chosen rows' activations in and out
    once."""
    d, ff, E = z["d"], z["ff"], z["E"]
    n = float(tokens * z["K"])
    return [(2.0 * n * d * 2 * ff, elt * (E * d * 2 * ff + n * (d + 2 * ff))),
            (2.0 * n * ff * d, elt * (E * ff * d + n * (ff + d)))]


def wkv(z, lens, elt=4):
    """rwkv6_chunked, one layer: per real token and head the state update
    and read-out (4 hd^2), r, k, v, w in and y out once, each row's final
    state out once (float32)."""
    H, hd = z["Hs"], z["hds"]
    tot = float(sum(lens))
    return 4.0 * H * hd * hd * tot, elt * (5.0 * H * hd * tot
                                            + len(lens) * H * hd * hd)
