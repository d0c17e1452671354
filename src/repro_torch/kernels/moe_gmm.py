"""Grouped (expert-batched) matmul of the MoE expert FFN: the wrapper of
csrc/moe_gmm.cu.

x [E, C, d] @ w [E, d, f] -> [E, C, f] in x's dtype: both operands widened
to f32, f32 sums, one cast at the end (the Pallas grouped_matmul's
contract). x, w and the output need a unit-stride last dim; their other
strides are taken as they lie. The model hands w over as the contiguous
[E, d, G ff] view of moe_w_in [E, d, G, ff], or moe_w_out [E, ff, d], so no
weight is copied or transposed per call.

On a CPU tensor this runs the plain version (kernels/ref.py:gmm_ref, the
einsum in f32); on a CUDA tensor it launches the kernel or raises. The
kernel takes float32 or bfloat16, x and w of one dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref


def grouped_matmul(x, w):
    """x [E, C, d]; w [E, d, f] -> [E, C, f] in x.dtype."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: want x [E, C, d] and w [E, d, f], "
                         f"got x {tuple(x.shape)} w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return kref.gmm_ref(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul: x and w must share float32 or "
                         f"bfloat16, got {x.dtype}/{w.dtype}")
    if w.device != x.device:
        raise ValueError(f"grouped_matmul: every operand must be on "
                         f"{x.device}, got {w.device}")
    if (d > 1 and x.stride(2) != 1) or (f > 1 and w.stride(2) != 1):
        raise ValueError(f"grouped_matmul: x and w need their last dim "
                         f"contiguous, got strides {x.stride()} {w.stride()}")
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("moe_gmm")
    fn = lib.grouped_matmul_launch
    fn.restype = _build.INT
    fn.argtypes = [_build.PTR] * 3 + [_build.INT] * 4 + [_build.I64] * 6 + \
        [_build.INT, _build.PTR]
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
             *x.stride()[:2], *w.stride()[:2], *out.stride()[:2],
             _build.dtype_code(x.dtype),
             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "grouped_matmul")
    _build.LAUNCHES["grouped_matmul"] += 1
    return out
