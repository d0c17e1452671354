"""Causal GQA flash-attention forward: the wrapper of csrc/flash_attention.cu.

q [B, H, Sq, hd], k/v [B, KV, Sk, hd] (any strides with hd contiguous) ->
[B, H, Sq, hd] in q's dtype, optionally restricted to a sliding window.
Sq must equal Sk: the kernel aligns q to the start of k, as the Pallas
kernel does, while the plain version (kernels/ref.py:attention_ref) aligns
the ends — the two agree only at Sq == Sk, the one case every caller
passes, so the wrapper refuses the rest on every device.

On a CPU tensor this runs the plain version; on a CUDA tensor it launches
the kernel or raises. See csrc/flash_attention.cu for what bounds the
kernel on the H100 and what its design does about it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_fwd(q, k, v, *, causal=True, window=0):
    """q [B,H,Sq,hd]; k,v [B,KV,Sk,hd] -> [B,H,Sq,hd]. The CUDA result is
    laid out [B, Sq, H, hd] in memory (a transposed view), so the model
    layout's transpose back (kernels/ops.py:attention) is free."""
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
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd_launch
    fn.restype = _build.INT
    fn.argtypes = [_build.PTR] * 4 + [_build.INT] * 8 + [_build.I64] * 12 + \
        [_build.INT, _build.PTR]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, KV, Sq, Sk, hd, int(bool(causal)), int(window),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], _build.dtype_code(q.dtype),
             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_fwd")
    _build.LAUNCHES["flash_attention_fwd"] += 1
    return out
