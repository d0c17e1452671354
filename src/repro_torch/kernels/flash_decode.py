"""One-token GQA decode attention: the wrappers of csrc/flash_decode.cu.

Two entry points share the kernel's inner loop (as `flash_decode` and
`flash_decode_paged` of src/repro/kernels/flash_decode.py share theirs):

  flash_decode        contiguous K/V [B, KV, S, hd], any strides with hd
                      contiguous — the Engine passes the cache group
                      `kf[i].transpose(1, 2)` as it lies, uncopied; `length`
                      is a scalar or a per-row [B] vector; with window > 0
                      only positions >= length - window count. The ragged
                      tail is masked, nothing is padded.
  flash_decode_paged  the serve pool [groups, num_pages + 1, page_size, KV,
                      hd] walked through the int32 block table inside the
                      kernel (-1 = unmapped: skipped), per-row lengths, group
                      `layer`. fp8 e4m3 pools are widened in the kernel.

Both return [B, H, hd] in q's dtype; a row with length 0 returns zeros.
On a CPU tensor each runs its plain version (kernels/ref.py); on a CUDA
tensor it launches the kernel or raises. See csrc/flash_decode.cu for what
bounds the kernel on the H100 and what its design does about it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8


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


def _check_device(q1, tensors, name):
    """The kernel's own limits; raises on what it does not take."""
    H, hd = q1.shape[1], q1.shape[2]
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


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _aligned(t, hd):
    """Each lane loads max(1, hd/32) elements as one vector of up to 16 bytes:
    the base and every row start must sit on that vector's size."""
    vb = min(16, max(1, hd // 32) * t.element_size())
    return t.data_ptr() % vb == 0 and all(
        s * t.element_size() % vb == 0 for s in t.stride()[:-1])


def flash_decode(q1, k, v, length, *, window=0):
    """q1 [B, H, hd]; k, v [B, KV, S, hd] (strided, hd contiguous); length
    a scalar or [B] int32. Returns [B, H, hd]."""
    B, S = q1.shape[0], k.shape[2]
    H, KV, hd = _check_common(q1, k, v, "flash_decode")
    if q1.device.type == "cpu":
        return kref.decode_ref(q1, k, v, length, window=window)
    _check_device(q1, (k, v), "flash_decode")
    if H // KV > MAX_GROUP:
        raise ValueError(f"flash_decode: GQA group {H // KV} > {MAX_GROUP}")
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError(f"flash_decode: k/v need equal strides with hd "
                         f"contiguous, got {k.stride()} / {v.stride()}")
    q1 = q1.contiguous()
    if not all(_aligned(t, hd) for t in (q1, k, v)):
        raise ValueError("flash_decode: q1/k/v rows are not vector-aligned")
    lens = kref._row_lengths(length, B, q1.device).contiguous()
    out = torch.empty_like(q1)
    fn = _build.entry("flash_decode", "flash_decode_launch",
                      [_build.PTR] * 5 + [_build.INT] * 5 + [_build.I64] * 3
                      + [_build.INT] * 3 + [_build.PTR])
    err = fn(q1.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lens.data_ptr(), B, H, KV, hd, S, k.stride(0), k.stride(1),
             k.stride(2), int(window), _build.dtype_code(q1.dtype),
             _build.dtype_code(k.dtype), _stream())
    _build.check(_build.load("flash_decode"), err, "flash_decode")
    _build.count("flash_decode")
    return out


def flash_decode_paged(q1, k_pool, v_pool, block_tab, lengths, *, layer=0):
    """q1 [B, H, hd]; pools [groups, num_pages + 1, page_size, KV, hd]
    (last page = trash); block_tab [B, pages_per_slot] int32, -1 =
    unmapped; lengths scalar or [B] int32; layer the group to read (an
    int). Returns [B, H, hd]."""
    B = q1.shape[0]
    H, KV, hd = _check_common(q1, k_pool, v_pool, "flash_decode_paged")
    groups, P1, ps = k_pool.shape[:3]
    if not 0 <= int(layer) < groups:
        raise ValueError(f"flash_decode_paged: layer {layer} outside the "
                         f"pool's {groups} groups")
    if block_tab.shape[0] != B:
        raise ValueError(f"flash_decode_paged: block_tab has "
                         f"{block_tab.shape[0]} rows for a batch of {B}")
    if q1.device.type == "cpu":
        return kref.decode_paged_ref(q1, k_pool, v_pool, block_tab, lengths,
                                     layer=layer)
    _check_device(q1, (k_pool, v_pool, block_tab), "flash_decode_paged")
    if H // KV > MAX_GROUP:
        raise ValueError(f"flash_decode_paged: GQA group {H // KV} > "
                         f"{MAX_GROUP}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("flash_decode_paged: the pools must be contiguous")
    if block_tab.dtype != torch.int32:
        raise ValueError(f"flash_decode_paged: block_tab must be int32, got "
                         f"{block_tab.dtype}")
    q1 = q1.contiguous()
    if not all(_aligned(t, hd) for t in (q1, k_pool, v_pool)):
        raise ValueError("flash_decode_paged: q1/pool rows are not "
                         "vector-aligned")
    tab = block_tab.contiguous()
    lens = kref._row_lengths(lengths, B, q1.device).contiguous()
    out = torch.empty_like(q1)
    fn = _build.entry("flash_decode", "flash_decode_paged_launch",
                      [_build.PTR] * 6 + [_build.INT] * 10 + [_build.PTR])
    err = fn(q1.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             out.data_ptr(), tab.data_ptr(), lens.data_ptr(), B, H, KV, hd,
             P1, ps, tab.shape[1], int(layer), _build.dtype_code(q1.dtype),
             _build.dtype_code(k_pool.dtype), _stream())
    _build.check(_build.load("flash_decode"), err, "flash_decode_paged")
    _build.count("flash_decode_paged")
    return out
