"""Chunked WKV6 recurrence (RWKV6 time-mix): the wrapper of
csrc/rwkv6_scan.cu.

r, k, v, w [B, H, S, hd] float32 (w = log-decay <= 0; any strides with hd
contiguous — the model hands over its [B, S, H, hd] activations through a
transposed view, uncopied), u [H, hd] -> (y [B, H, S, hd] float32, the
final state [B, H, hd, hd] float32), starting from a zero state. The CUDA
y is laid out [B, S, H, hd] in memory (a transposed view), so the model's
transpose back is free.

On a CPU tensor this runs the plain version (kernels/ref.py:rwkv6_ref, the
sequential recurrence); on a CUDA tensor it launches the kernel of one
route or raises. `_route` picks the route from strides and alignment:

  tile  r, k, v, w rows copyable in 16-byte vectors (as the model's views
        always are): a block per (row, head, slice of 32 state columns),
        register tiles, cp.async double buffering
  simt  any other strides with hd contiguous: a block per (row, head)

`_build.ROUTES["rwkv6_chunked"]` counts the launches of each. On a meta
tensor the wrapper reports the launch and `cost()` to the active cost
counter and returns the empty outputs. The kernel
takes float32 only: its chunked form scales k by up to e^64 (see
csrc/rwkv6_scan.cu), which bf16 or TF32 products would not survive.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.launch import costs

HEAD_DIMS = (64,)         # rwkv6-3b: 40 heads of 64
_ARGS = [_build.PTR] * 7 + [_build.INT] * 4 + [_build.I64] * 6 + \
    [_build.INT, _build.PTR]


def _route(r, k, v, w) -> str:
    """The route a CUDA launch over r, k, v, w takes: a pure function of
    strides and alignment (the CPU tests call it on CPU tensors)."""
    return "tile" if all(_build.vec16_ok(t) for t in (r, k, v, w)) \
        else "simt"


CHUNK = 16               # csrc/rwkv6_scan.cu's chunk


def cost(r, k, v, w, u) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: r, k, v, w and u read once, y and the
    final state written once (f32); per chunk of 16 the scores and y's
    intra-chunk term (2 x 2 C^2 hd) and the inter-chunk term and state
    update (2 x 2 C hd^2), for every (row, head)."""
    B, H, S, hd = r.shape
    elems = B * H * S * hd
    nbytes = 4 * (5 * elems + H * hd + B * H * hd * hd)
    flops = B * H * -(-S // CHUNK) * (4 * CHUNK * CHUNK * hd
                                      + 4 * CHUNK * hd * hd)
    return float(flops), float(nbytes)


def rwkv6_chunked(r, k, v, w, u, *, route=None):
    """r,k,v,w [B,H,S,hd] (w <= 0); u [H,hd]. Returns (y, final_state).
    `route` (for measurement) forces the simt route instead of `_route`'s
    pick."""
    B, H, S, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or \
            tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_chunked: r/k/v/w must share [B,H,S,hd] and "
                         f"u be [H,hd], got {tuple(r.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} "
                         f"{tuple(w.shape)} u {tuple(u.shape)}")
    if r.device.type == "cpu":
        return kref.rwkv6_ref(r, k, v, w, u)
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_chunked: head_dim {hd} not in {HEAD_DIMS}")
    for t in (r, k, v, w, u):
        if t.dtype != torch.float32:
            raise ValueError(f"rwkv6_chunked: the kernel takes float32 only, "
                             f"got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"rwkv6_chunked: every operand must be on "
                             f"{r.device}, got {t.device}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)) or \
            len({t.stride() for t in (r, k, v, w)}) != 1:
        raise ValueError(f"rwkv6_chunked: r/k/v/w need equal strides with hd "
                         f"contiguous, got "
                         f"{[t.stride() for t in (r, k, v, w)]}")
    picked = _route(r, k, v, w)
    if route not in (None, picked, "simt"):
        raise ValueError(f"rwkv6_chunked: route {route!r} cannot take these "
                         f"operands (their route is {picked!r})")
    route = route or picked
    u = u.contiguous()
    y = torch.empty((B, S, H, hd), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if state.numel() == 0:
        return y, state
    if r.device.type == "meta":
        costs.kernel("rwkv6_chunked", route, *cost(r, k, v, w, u))
        return y, state
    fn = _build.entry("rwkv6_scan", "rwkv6_chunked_launch", _ARGS)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), y.data_ptr(), state.data_ptr(), B, H, S, hd,
             r.stride(0), r.stride(1), r.stride(2), y.stride(0), y.stride(1),
             y.stride(2), int(route == "tile"), torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load("rwkv6_scan"), err, "rwkv6_chunked")
    _build.count("rwkv6_chunked", route)
    return y, state
