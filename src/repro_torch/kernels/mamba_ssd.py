"""Chunked SSD (Mamba-2, one decay scalar per head): the wrapper of
csrc/mamba_ssd.cu.

x [B, H, S, P], dt [B, H, S] (>= 0), B_ and C_ [B, S, N] (shared by every
head), a [H] (< 0), all float32 -> (y [B, H, S, P] float32, the final
state [B, H, N, P] float32), starting from a zero state. x, B_ and C_ may
have any strides with their last dim contiguous, dt any strides: the model
hands over column slices of its conv output and transposed views,
uncopied. The CUDA y is laid out [B, S, H, P] in memory (a transposed
view), so the model's transpose back is free.

On a CPU tensor this runs the plain version (kernels/ref.py:ssd_ref, the
sequential recurrence); on a CUDA tensor it launches the kernel of one
route or raises. `_route` picks the route from strides and alignment:

  tile  x, B_ and C_ rows copyable in 16-byte vectors (as the model's
        views always are), at either state: f32 FMA on register tiles
        fed by 16-byte shared loads, C B^T once per chunk for the heads
        of a block, operands landing by cp.async ahead of their chunk.
        The tiling is fixed at compile time by N. State 16 (hymba): a
        block per (row, pair of heads, slice of 32 state columns), x, B,
        C and dt in a 2-stage ring (94 KB of shared memory, 2 blocks an
        SM). State 128 (granite-4.0-h's Mamba-2 layers): a block per
        (row, pair of heads) over all 64 columns, B / C / dt in a 2-stage
        ring and one x buffer a head (221 KB, one block an SM: a ring of
        x, B and C would need 286 KB); each thread keeps a 4 x 8 slice of
        each head's state in registers. Bound by operations there (the
        read-out C h and the state update, 4 C N P a chunk and head)
  simt  any other strides with the last dims contiguous (the first
        design, kept for them): a block per (row, head), the state in
        shared memory

`_build.ROUTES["ssd_chunked"]` counts the launches of each. On a meta
tensor the wrapper reports the launch and `cost()` to the active cost
counter and returns the empty outputs. The kernel
takes float32 only, as the model hands it over.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.launch import costs

# (P, N) built, each on both routes: hymba-1.5b (50 heads of 64, state 16)
# and granite-4.0-h (128 heads of 64, state 128); the tile route's tiling
# is chosen by N (csrc/mamba_ssd.cu: SsdTile<N>)
SHAPES = ((64, 16), (64, 128))
_ARGS = [_build.PTR] * 7 + [_build.INT] * 5 + [_build.I64] * 13 + \
    [_build.INT, _build.PTR]


def _route(x, B_, C_) -> str:
    """The route a CUDA launch over x, B_, C_ takes: a pure function of
    the state shape, strides and alignment (the CPU tests call it on CPU
    tensors; dt is read 4 bytes at a time, any strides)."""
    tiled = (x.shape[-1], B_.shape[-1]) in SHAPES
    return "tile" if tiled and all(_build.vec16_ok(t) for t in (x, B_, C_)) \
        else "simt"


CHUNK = 64               # csrc/mamba_ssd.cu's chunk


def cost(x, dt, B_, C_, a) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: x, dt, B_, C_ and a read once, y and the
    final state written once (f32); per (row, chunk of n rows) C B^T over
    the causal triangle (2 tri N), and per (row, head, chunk) y's
    intra-chunk term over the triangle (2 tri P), the inter-chunk term and
    the state update (2 x 2 n N P)."""
    B, H, S, P = x.shape
    N = B_.shape[-1]
    flops = 0
    for t0 in range(0, S, CHUNK):
        n = min(CHUNK, S - t0)
        tri = n * (n + 1) // 2
        flops += B * 2 * tri * N + B * H * (2 * tri * P + 4 * n * N * P)
    nbytes = 4 * (2 * B * H * S * P + B * H * S + 2 * B * S * N + H
                  + B * H * N * P)
    return float(flops), float(nbytes)


def ssd_chunked(x, dt, B_, C_, a, *, route=None):
    """x [B,H,S,P]; dt [B,H,S]; B_/C_ [B,S,N]; a [H] < 0. Returns (y,
    final_state). `route` (for measurement) forces the simt route instead
    of `_route`'s pick."""
    B, H, S, P = x.shape
    N = B_.shape[-1]
    if tuple(dt.shape) != (B, H, S) or tuple(B_.shape) != (B, S, N) or \
            tuple(C_.shape) != (B, S, N) or tuple(a.shape) != (H,):
        raise ValueError(f"ssd_chunked: want x [B,H,S,P], dt [B,H,S], B_/C_ "
                         f"[B,S,N] and a [H], got x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B_ {tuple(B_.shape)} C_ "
                         f"{tuple(C_.shape)} a {tuple(a.shape)}")
    if x.device.type == "cpu":
        return kref.ssd_ref(x, dt, B_, C_, a)
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_chunked: (P, N) = ({P}, {N}) not in {SHAPES}")
    for t in (x, dt, B_, C_, a):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_chunked: the kernel takes float32 only, "
                             f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ssd_chunked: every operand must be on "
                             f"{x.device}, got {t.device}")
    if x.stride(3) != 1 or B_.stride(2) != 1 or C_.stride(2) != 1:
        raise ValueError(f"ssd_chunked: x, B_ and C_ need their last dim "
                         f"contiguous, got strides {x.stride()} "
                         f"{B_.stride()} {C_.stride()}")
    picked = _route(x, B_, C_)
    if route not in (None, picked, "simt"):
        raise ValueError(f"ssd_chunked: route {route!r} cannot take these "
                         f"operands (their route is {picked!r})")
    route = route or picked
    a = a.contiguous()
    y = torch.empty((B, S, H, P), dtype=torch.float32,
                    device=x.device).transpose(1, 2)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if state.numel() == 0:
        return y, state
    if x.device.type == "meta":
        costs.kernel("ssd_chunked", route, *cost(x, dt, B_, C_, a))
        return y, state
    fn = _build.entry("mamba_ssd", "ssd_chunked_launch", _ARGS)
    err = fn(x.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
             a.data_ptr(), y.data_ptr(), state.data_ptr(), B, H, S, P, N,
             *x.stride()[:3], *dt.stride(), *B_.stride()[:2],
             *C_.stride()[:2], *y.stride()[:3], int(route == "tile"),
             torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load("mamba_ssd"), err, "ssd_chunked")
    _build.count("ssd_chunked", route)
    return y, state
