"""Grouped (expert-batched) matmul of the MoE expert FFN: the wrapper of
csrc/moe_gmm.cu.

x [E, C, d] @ w [E, d, f] -> [E, C, f] in x's dtype: products of the
inputs, f32 sums over d, one cast at the end (the Pallas grouped_matmul's
contract). x, w and the output need a unit-stride last dim; their other
strides are taken as they lie. The model hands w over as the contiguous
[E, d, G ff] view of moe_w_in [E, d, G, ff], or moe_w_out [E, ff, d], so no
weight is copied or transposed per call.

On a CPU tensor this runs the plain version (kernels/ref.py:gmm_ref, the
einsum in f32); on a CUDA tensor it launches the kernel of one route or
raises. `_route` picks the route from dtype, shape, strides and alignment:

  tc_decode   bf16, C <= 16: swapped (f on the M side) mma.sync tensor-core
              tiles fed by a 4-stage cp.async ring of weight tiles
  tc_prefill  bf16, C > 16: swapped wgmma tiles (128 f x 160 C) fed by TMA
              through a 4-stage ring with a producer warp
  simt_bf16   bf16 that the tensor-core routes cannot take (d or f not a
              multiple of 8, a stride not a multiple of 8 elements, a base
              not 16-byte aligned): f32-FMA tiles
  simt_f32    float32: the same f32-FMA tiles, so f32 stays true f32

`_build.ROUTES["grouped_matmul"]` counts the launches of each route.
On a meta tensor the wrapper reports the launch and `cost()` to the
active cost counter and returns the empty output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.launch import costs

NAME = "grouped_matmul"
DECODE_C = 16          # C at or under this takes the decode tiling
_CODES = {"simt_bf16": 0, "simt_f32": 0, "tc_decode": 1, "tc_prefill": 2}
_ARGTYPES = [_build.PTR] * 3 + [_build.INT] * 4 + [_build.I64] * 6 + \
    [_build.INT, _build.INT, _build.PTR]


def _route(x, w) -> str:
    """The route a CUDA launch of grouped_matmul(x, w) takes: a pure
    function of dtype, shape, strides and alignment (the CPU tests call it
    on CPU tensors)."""
    if x.dtype == torch.float32:
        return _build.simt_route(x.dtype)
    if not (_build.vec16_ok(x) and _build.vec16_ok(w)):
        return "simt_bf16"
    return "tc_decode" if x.shape[1] <= DECODE_C else "tc_prefill"


def cost(x, w) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: x and w read once, the output written
    once; 2 E C d f FLOPs."""
    E, C, d = x.shape
    f = w.shape[2]
    nbytes = x.element_size() * (E * C * d + E * d * f + E * C * f)
    return 2.0 * E * C * d * f, float(nbytes)


def grouped_matmul(x, w, *, route=None):
    """x [E, C, d]; w [E, d, f] -> [E, C, f] in x.dtype. `route` (for
    measurement) forces the SIMT route of x's dtype instead of `_route`'s
    pick; any other route than those two raises."""
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
    picked = _route(x, w)
    if route is None:
        route = picked
    elif route not in (picked, _build.simt_route(x.dtype)):
        raise ValueError(f"grouped_matmul: route {route!r} cannot take these "
                         f"operands (their route is {picked!r})")
    if x.device.type == "meta":
        costs.kernel(NAME, route, *cost(x, w))
        return out
    fn = _build.entry("moe_gmm", "grouped_matmul_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
             *x.stride()[:2], *w.stride()[:2], *out.stride()[:2],
             _build.dtype_code(x.dtype), _CODES[route],
             torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load("moe_gmm"), err, NAME)
    _build.count(NAME, route)
    return out
