"""Causal GQA flash-attention forward: the wrapper of csrc/flash_attention.cu.

q [B, H, Sq, hd], k/v [B, KV, Sk, hd] (any strides with hd contiguous) ->
[B, H, Sq, hd] in q's dtype, optionally restricted to a sliding window.
Sq must equal Sk: the kernel aligns q to the start of k, as the Pallas
kernel does, while the plain version (kernels/ref.py:attention_ref) aligns
the ends — the two agree only at Sq == Sk, the one case every caller
passes, so the wrapper refuses the rest on every device.

On a CPU tensor this runs the plain version; on a CUDA tensor it launches
the kernel of one route or raises. `_route` picks the route from dtype,
head dim, strides and alignment:

  tc         bf16 with 16-byte aligned rows (every head dim):
             flash-attention-2 on mma.sync tensor-core tiles, P kept in
             registers as bf16
  simt_bf16  other bf16 (unaligned rows): f32-FMA tiles
  simt_f32   float32: the same f32-FMA tiles, so f32 stays true f32

`_build.ROUTES["flash_attention_fwd"]` counts the launches of each route.
On a meta tensor the wrapper reports the launch and `cost()` to the
active cost counter and returns the empty output.
See csrc/flash_attention.cu for what bounds each route on the H100 and
what its design does about it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.launch import costs

NAME = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128, 256)
_ARGTYPES = [_build.PTR] * 4 + [_build.INT] * 8 + [_build.I64] * 12 + \
    [_build.INT, _build.INT, _build.PTR]


def _route(q, k, v) -> str:
    """The route a CUDA launch of flash_attention_fwd(q, k, v) takes: a pure
    function of dtype, strides and alignment (the CPU tests call it on CPU
    tensors)."""
    if q.dtype == torch.float32:
        return _build.simt_route(q.dtype)
    if all(_build.vec16_ok(t) for t in (q, k, v)):
        return "tc"
    return "simt_bf16"


def cost(q, k, v, *, causal=True, window=0) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: q, k, v read once and the output written
    once; 4 hd FLOPs (QK^T and PV) a (query, key) pair the mask keeps, for
    every query head."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if causal:
        w = window if window > 0 else Sq
        pairs = sum(min(i + 1, w) for i in range(Sq))
    else:
        pairs = Sq * Sk
    nbytes = q.element_size() * 2 * B * H * Sq * hd + \
        k.element_size() * 2 * B * KV * Sk * hd
    return 4.0 * B * H * hd * pairs, float(nbytes)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, route=None):
    """q [B,H,Sq,hd]; k,v [B,KV,Sk,hd] -> [B,H,Sq,hd]. The CUDA result is
    laid out [B, Sq, H, hd] in memory (a transposed view), so the model
    layout's transpose back (kernels/ops.py:attention) is free. `route`
    (for measurement) forces the SIMT route of q's dtype instead of
    `_route`'s pick; any other route than those two raises."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if Sq != Sk:
        raise ValueError(
            f"flash_attention_fwd needs Sq == Sk (got {Sq} != {Sk}): the "
            f"kernel aligns q to the start of k while attention_ref aligns "
            f"the ends, so the two disagree whenever the lengths differ")
    if k.shape != v.shape or H % KV:
        raise ValueError(f"flash_attention_fwd: bad shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return kref.attention_ref(q, k, v, causal=causal, window=window)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: q/k/v must share float32 or "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: every operand must be on "
                             f"{q.device}, got {t.device}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: hd must be contiguous")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    picked = _route(q, k, v)
    if route is None:
        route = picked
    elif route not in (picked, _build.simt_route(q.dtype)):
        raise ValueError(f"flash_attention_fwd: route {route!r} cannot take "
                         f"these operands (their route is {picked!r})")
    if q.device.type == "meta":
        costs.kernel(NAME, route, *cost(q, k, v, causal=causal,
                                        window=window))
        return out
    fn = _build.entry("flash_attention", "flash_attention_fwd_launch",
                      _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, KV, Sq, Sk, hd, int(bool(causal)), int(window),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], _build.dtype_code(q.dtype),
             int(route == "tc"), torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load("flash_attention"), err, NAME)
    _build.count(NAME, route)
    return out
