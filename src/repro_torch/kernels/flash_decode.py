"""One-token GQA decode attention: the wrappers of csrc/flash_decode.cu.

Two entry points share the kernel body (as `flash_decode` and
`flash_decode_paged` of src/repro/kernels/flash_decode.py share theirs):

  flash_decode        contiguous K/V [B, KV, S, hd], any strides with hd
                      contiguous — the Engine passes the cache group
                      `kf[i].transpose(1, 2)` as it lies, uncopied; `length`
                      is a scalar or a per-row [B] vector; with window > 0
                      only positions >= length - window count. The ragged
                      tail is masked, nothing is padded.
  flash_decode_paged  the serve pool [groups, num_pages + 1, page_size, KV,
                      hd] walked through the int32 block table inside the
                      kernel (-1 = unmapped: never read), per-row lengths,
                      group `layer`. fp8 e4m3 pools are widened in the kernel.

Both return [B, H, hd] in q's dtype; a row with length 0 returns zeros.
On a CPU tensor each runs its plain version (kernels/ref.py); on a CUDA
tensor it launches the kernel of one route or raises. `_route` picks the
route from dtype, strides and alignment:

  tc         bf16 q, a bf16 or fp8 cache with 16-byte aligned rows (every
             head dim): the GQA group on mma.sync tensor-core tiles, P
             kept in registers as bf16
  simt_bf16  other bf16 (unaligned rows): f32-FMA
  simt_f32   float32: f32-FMA, so f32 stays true f32

Every route may split each row's positions across blocks (`_splits`, from
static shapes and the route only) and then merges the splits' partial
softmax states inside the same launch. `_build.ROUTES[name]` counts the
launches of each route. On a meta tensor a wrapper reports the launch and
its `cost()` (every row at its full capacity: a meta length has no value)
to the active cost counter and returns the empty output.
See csrc/flash_decode.cu for what bounds the kernel on the H100 and what
its design does about it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.launch import costs

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
TILE = 16              # positions of a tensor-core tile; a chunk is a multiple
MIN_BLOCKS = 2 * 132   # two blocks on each of the H100 SXM's 132 SMs
MAX_SPLITS = 64        # csrc/flash_decode.cu:MAX_SPLITS, the merge's bound
# positions a block of the route keeps in flight (tc: 8 warps, each with a
# 2-stage ring of 16-position tiles; simt: 4 warps of 4 positions): a chunk
# is never shorter, as a split costs its merge more than walking these
# (chip_smoke.py phase 2's split sweep)
SPAN = {"tc": 256, "simt_bf16": 16, "simt_f32": 16}
# at hd 256 a tc block has 6 walking warps (csrc/flash_decode.cu:
# TC_WARPS_HD256: a warp's ring takes 33 KB of shared memory)
SPAN_HD256 = dict(SPAN, tc=2 * TILE * 6)
_ARGS = {"flash_decode": [_build.PTR] * 7 + [_build.INT] * 5
         + [_build.I64] * 3 + [_build.INT] * 6 + [_build.PTR],
         "flash_decode_paged": [_build.PTR] * 8 + [_build.INT] * 13
         + [_build.PTR]}
_TICKETS: dict = {}


def _splits(B: int, KV: int, cap: int, route: str,
            hd: int = 128) -> tuple[int, int]:
    """(splits, chunk): each (row, kv head) pair's positions [0, cap) go to
    `splits` blocks of `chunk` positions (a multiple of TILE, at least the
    route's span at head dim `hd`), enough that B * KV * splits reaches
    MIN_BLOCKS where the capacity allows. A pure function of static shapes
    and the route: the lengths live on the device, and reading them here
    would stall the host-bound decode step and break CUDA-graph capture."""
    span = (SPAN_HD256 if hd == 256 else SPAN)[route]
    want = min(MAX_SPLITS, -(-MIN_BLOCKS // max(1, B * KV)))
    tiles = max(1, -(-cap // TILE))
    chunk = TILE * min(tiles, max(span // TILE,
                                  (cap + TILE * want // 2) // (TILE * want),
                                  -(-cap // (TILE * MAX_SPLITS))))
    return -(-tiles * TILE // chunk), chunk


def _live(lens, B: int, cap: int, window: int = 0) -> int:
    """Positions a call reads: each row's length (a scalar or [B]), cut to
    `cap` and to the window; every row at `cap` when the lengths have no
    value (meta)."""
    if isinstance(lens, torch.Tensor) and lens.device.type == "meta":
        n = [cap] * B
    else:
        n = [min(max(int(x), 0), cap)
             for x in kref._row_lengths(lens, B, "cpu").tolist()]
    return sum(min(x, window) if window > 0 else x for x in n)


def cost(q1, k, v, length, *, window=0) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash_decode call: q1 read and the output
    written once, each row's live K/V positions read once, the lengths
    (int32); 4 hd FLOPs a live position for every query head."""
    B, H, hd = q1.shape
    KV, S = k.shape[1], k.shape[2]
    live = _live(length, B, S, window)
    nbytes = q1.element_size() * 2 * B * H * hd + \
        k.element_size() * 2 * live * KV * hd + 4 * B
    return 4.0 * H * hd * live, float(nbytes)


def cost_paged(q1, k_pool, v_pool, block_tab, lengths) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash_decode_paged call: as cost(), plus the
    block table (int32)."""
    B, H, hd = q1.shape
    KV, ps = k_pool.shape[-2], k_pool.shape[2]
    npg = block_tab.shape[1]
    live = _live(lengths, B, npg * ps)
    nbytes = q1.element_size() * 2 * B * H * hd + \
        k_pool.element_size() * 2 * live * KV * hd + 4 * (B * npg + B)
    return 4.0 * H * hd * live, float(nbytes)


def _route(q1, k, v) -> str:
    """The route a CUDA launch over q1 and the cache (k, v: the view or the
    pools) takes: a pure function of dtype, strides and alignment (the CPU
    tests call it on CPU tensors)."""
    if q1.dtype == torch.float32:
        return _build.simt_route(q1.dtype)
    if all(_build.vec16_ok(t) for t in (q1, k, v)):
        return "tc"
    return "simt_bf16"


def _check_common(q1, k, v, name):
    if q1.dim() != 3:
        raise ValueError(f"{name}: q1 must be [B, H, hd], got {tuple(q1.shape)}")
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"{name}: k and v must share shape and dtype, got "
                         f"{tuple(k.shape)}/{k.dtype} and "
                         f"{tuple(v.shape)}/{v.dtype}")
    H, hd = q1.shape[1], q1.shape[2]
    KV = k.shape[-2] if name == "flash_decode_paged" else k.shape[1]
    if H % KV:
        raise ValueError(f"{name}: {H} query heads do not group over {KV} "
                         f"kv heads")
    return H, KV, hd


def _check_device(q1, KV, tensors, name):
    """The kernel's own limits; raises on what it does not take."""
    H, hd = q1.shape[1], q1.shape[2]
    if H // KV > MAX_GROUP:
        raise ValueError(f"{name}: GQA group {H // KV} > {MAX_GROUP}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    kv_dt = tensors[0].dtype
    if q1.dtype not in (torch.float32, torch.bfloat16) or \
            kv_dt not in (q1.dtype, torch.float8_e4m3fn):
        raise ValueError(f"{name}: q1 must be float32/bfloat16 and k/v that "
                         f"dtype or float8_e4m3fn, got {q1.dtype} / {kv_dt}")
    for t in tensors:
        if t.device != q1.device:
            raise ValueError(f"{name}: every operand must be on {q1.device}, "
                             f"got {t.device}")


def _pick(q1, k, v, route, name):
    """`_route`'s pick, or the forced `route` (for measurement: the SIMT
    route of q1's dtype); any other route raises."""
    picked = _route(q1, k, v)
    if route is None or route == picked:
        return picked
    if route != _build.simt_route(q1.dtype):
        raise ValueError(f"{name}: route {route!r} cannot take these "
                         f"operands (their route is {picked!r})")
    return route


def _launch(name, q1, k, v, B, KV, cap, route, lens, extra, tail, work):
    """Allocate the output and the split scratch, launch, count (on meta:
    report `work()`, the call's (FLOPs, bytes), instead)."""
    H, hd = q1.shape[1], q1.shape[2]
    out = torch.empty_like(q1)
    if out.numel() == 0:
        return out
    nsplit, chunk = _splits(B, KV, cap, route, hd)
    part = tickets = None
    if nsplit > 1:
        part = torch.empty(B * KV * nsplit * (H // KV) * (hd + 2),
                           dtype=torch.float32, device=q1.device)
    if q1.device.type == "meta":
        costs.kernel(name, route, *work())
        return out
    if nsplit > 1:
        tickets = _tickets(B * KV, q1.device)
    fn = _build.entry("flash_decode", f"{name}_launch", _ARGS[name])
    err = fn(q1.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *(t.data_ptr() for t in extra),
             lens.data_ptr(), None if part is None else part.data_ptr(),
             None if tickets is None else tickets.data_ptr(), B, H, KV, hd,
             *tail, nsplit, chunk, _build.dtype_code(q1.dtype),
             _build.dtype_code(k.dtype), int(route == "tc"),
             torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load("flash_decode"), err, name)
    _build.count(name, route)
    return out


def _tickets(n, device):
    """The split merge's counters, one per (row, kv head): zeros made once
    per device (grown when a launch needs more) and left at zero by every
    launch, whose last split of a pair takes the ticket that wraps its
    counter back. Launches on one stream run one after the other, so they
    share it.

    The buffer assumes one stream per device: every path launches on the
    thread's current stream, the default stream, the Router's replica
    threads included. Two streams could run two split launches at once and
    mix their counters, so a stream per replica would need a ticket buffer
    per stream."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return t


def flash_decode(q1, k, v, length, *, window=0, route=None):
    """q1 [B, H, hd]; k, v [B, KV, S, hd] (strided, hd contiguous); length
    a scalar or [B] int32. Returns [B, H, hd]. `route` (for measurement)
    forces the SIMT route of q1's dtype instead of `_route`'s pick."""
    name = "flash_decode"
    B, S = q1.shape[0], k.shape[2]
    H, KV, hd = _check_common(q1, k, v, name)
    if q1.device.type == "cpu":
        return kref.decode_ref(q1, k, v, length, window=window)
    _check_device(q1, KV, (k, v), name)
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError(f"{name}: k/v need equal strides with hd "
                         f"contiguous, got {k.stride()} / {v.stride()}")
    q1 = q1.contiguous()
    route = _pick(q1, k, v, route, name)
    lens = kref._row_lengths(length, B, q1.device).contiguous()
    return _launch(name, q1, k, v, B, KV, S, route, lens, (),
                   (S, *k.stride()[:3], int(window)),
                   lambda: cost(q1, k, v, lens, window=window))


def flash_decode_paged(q1, k_pool, v_pool, block_tab, lengths, *, layer=0,
                       route=None):
    """q1 [B, H, hd]; pools [groups, num_pages + 1, page_size, KV, hd]
    (last page = trash); block_tab [B, pages_per_slot] int32, -1 =
    unmapped; lengths scalar or [B] int32; layer the group to read (an
    int). Returns [B, H, hd]. `route` as in flash_decode.

    A -1 page inside a row's length is read by nothing here (as in the
    TPU kernel), where the plain version reads the trash page: the two
    agree on rows whose live positions all lie on mapped pages. The
    Scheduler's idle slots (position 0, no pages) are the other rows, and
    their outputs are discarded."""
    name = "flash_decode_paged"
    B = q1.shape[0]
    H, KV, hd = _check_common(q1, k_pool, v_pool, name)
    groups, P1, ps = k_pool.shape[:3]
    if not 0 <= int(layer) < groups:
        raise ValueError(f"{name}: layer {layer} outside the pool's {groups} "
                         f"groups")
    if block_tab.shape[0] != B:
        raise ValueError(f"{name}: block_tab has {block_tab.shape[0]} rows "
                         f"for a batch of {B}")
    if q1.device.type == "cpu":
        return kref.decode_paged_ref(q1, k_pool, v_pool, block_tab, lengths,
                                     layer=layer)
    _check_device(q1, KV, (k_pool, v_pool, block_tab), name)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{name}: the pools must be contiguous")
    if block_tab.dtype != torch.int32:
        raise ValueError(f"{name}: block_tab must be int32, got "
                         f"{block_tab.dtype}")
    q1 = q1.contiguous()
    route = _pick(q1, k_pool, v_pool, route, name)
    tab = block_tab.contiguous()
    lens = kref._row_lengths(lengths, B, q1.device).contiguous()
    npg = tab.shape[1]
    return _launch(name, q1, k_pool, v_pool, B, KV, npg * ps, route, lens,
                   (tab,), (P1, ps, npg, int(layer)),
                   lambda: cost_paged(q1, k_pool, v_pool, tab, lens))
