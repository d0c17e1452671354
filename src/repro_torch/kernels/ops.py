"""Backend dispatch and layout adapters over the Hopper kernels.

BACKENDS:
  "ref"   the kernels' plain PyTorch versions (kernels/ref.py)
  "cuda"  the Hopper kernel wrappers: on a CUDA tensor they launch the
          kernel (or raise); on a CPU tensor they run the plain version

The model calls these only with kernel_backend="cuda"; with "ref" it takes
its own plain paths (models/attention.py for attention, the chunked torch
scans of models/ssm.py for the RWKV6 time-mix and the SSD mix, the einsums
of models/moe.py for the MoE expert FFN), as the JAX package does.
The layout adapters between the model convention ([B, S, H, hd]) and the
kernel convention ([B, H, S, hd]) live here; both are views, no copies.
"""
from __future__ import annotations

from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.mamba_ssd import ssd_chunked
from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked

BACKENDS = ("ref", "cuda")


def check_backend(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {name!r}: expected one of {BACKENDS}")
    return name


def attention(q, k, v, *, causal=True, window=0, backend="ref"):
    """Model layout: q [B,S,H,hd], k/v [B,S,KV,hd] -> [B,S,H,hd]."""
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    if check_backend(backend) == "ref":
        o = kref.attention_ref(qT, kT, vT, causal=causal, window=window)
    else:
        o = flash_attention_fwd(qT, kT, vT, causal=causal, window=window)
    return o.transpose(1, 2)


def decode_attention(q1, k, v, length, *, window=0, backend="ref"):
    """q1 [B,H,hd]; k/v [B,KV,S,hd] kernel-native; length scalar or [B]."""
    if check_backend(backend) == "ref":
        return kref.decode_ref(q1, k, v, length, window=window)
    return flash_decode(q1, k, v, length, window=window)


def decode_attention_paged(q1, k_pool, v_pool, block_tab, lengths, *,
                           layer=0, backend="ref"):
    """Paged decode: pools [groups, num_pages+1, page_size, KV, hd] walked
    through block_tab [B, pages_per_slot] with per-row lengths. The "ref"
    backend gathers the paged view first (the materialization the kernel
    avoids)."""
    if check_backend(backend) == "ref":
        return kref.decode_paged_ref(q1, k_pool, v_pool, block_tab, lengths,
                                     layer=layer)
    return flash_decode_paged(q1, k_pool, v_pool, block_tab, lengths,
                              layer=layer)


def rwkv6(r, k, v, w, u, *, backend="ref"):
    """Kernel layout: r,k,v,w [B,H,S,hd] (w = log-decay <= 0), u [H,hd] ->
    (y [B,H,S,hd], final state [B,H,hd,hd] f32), from a zero state."""
    if check_backend(backend) == "ref":
        return kref.rwkv6_ref(r, k, v, w, u)
    return rwkv6_chunked(r, k, v, w, u)


def ssd(x, dt, B_, C_, a, *, backend="ref"):
    """Kernel layout: x [B,H,S,P], dt [B,H,S], B_/C_ [B,S,N], a [H] < 0 ->
    (y [B,H,S,P], final state [B,H,N,P] f32), from a zero state."""
    if check_backend(backend) == "ref":
        return kref.ssd_ref(x, dt, B_, C_, a)
    return ssd_chunked(x, dt, B_, C_, a)


def gmm(x, w, *, backend="ref"):
    """Grouped (expert-batched) matmul x [E,C,d] @ w [E,d,f] -> [E,C,f] in
    x's dtype, summed in f32."""
    if check_backend(backend) == "ref":
        return kref.gmm_ref(x, w)
    return grouped_matmul(x, w)
