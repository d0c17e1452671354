"""Backend dispatch and layout adapters over the Hopper kernels.

BACKENDS:
  "ref"   the kernels' plain PyTorch versions (kernels/ref.py); the default,
          as in the JAX package
  "cuda"  the Hopper kernel wrappers: on a CUDA tensor they launch the
          kernel (or raise); on a CPU tensor they run the plain version; on
          a meta tensor (the dry run) they report the launch to the active
          cost counter and return an empty output

KERNEL_BACKEND is the process-global backend an op uses when its
`backend` is None (the JAX package's switch): `set_backend` sets it,
`use_backend` scopes it and restores the previous one on exit.

The model calls these only with kernel_backend="cuda"; with "ref" it takes
its own plain paths (models/attention.py for attention, the chunked torch
scans of models/ssm.py for the RWKV6 time-mix and the SSD mix, the einsums
of models/moe.py for the MoE expert FFN), as the JAX package does.
The layout adapters between the model convention ([B, S, H, hd]) and the
kernel convention ([B, H, S, hd]) live here; both are views, no copies.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from repro_torch.kernels.mamba_ssd import ssd_chunked
from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked

BACKENDS = ("ref", "cuda")

KERNEL_BACKEND = "ref"


def check_backend(name) -> str:
    """`name`, validated; None means the ambient KERNEL_BACKEND."""
    if name is None:
        return KERNEL_BACKEND
    if name not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {name!r}: expected one of {BACKENDS}")
    return name


def set_backend(name: str):
    global KERNEL_BACKEND
    if name is None:
        raise ValueError(f"unknown kernel backend None: expected one of "
                         f"{BACKENDS}")
    KERNEL_BACKEND = check_backend(name)


@contextlib.contextmanager
def use_backend(name: str):
    """Scoped backend switch: restores the previous backend on exit, so a
    test cannot leak a process-global setting into the next."""
    global KERNEL_BACKEND
    prev = KERNEL_BACKEND
    set_backend(name)
    try:
        yield
    finally:
        KERNEL_BACKEND = prev


def attention(q, k, v, *, causal=True, window=0, backend=None):
    """Model layout: q [B,S,H,hd], k/v [B,S,KV,hd] -> [B,S,H,hd]."""
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    if check_backend(backend) == "ref":
        o = kref.attention_ref(qT, kT, vT, causal=causal, window=window)
    else:
        o = flash_attention_fwd(qT, kT, vT, causal=causal, window=window)
    return o.transpose(1, 2)


def decode_attention(q1, k, v, length, *, window=0, backend=None):
    """q1 [B,H,hd]; k/v [B,KV,S,hd] kernel-native; length scalar or [B]."""
    if check_backend(backend) == "ref":
        return kref.decode_ref(q1, k, v, length, window=window)
    return flash_decode(q1, k, v, length, window=window)


def decode_attention_paged(q1, k_pool, v_pool, block_tab, lengths, *,
                           layer=0, backend=None):
    """Paged decode: pools [groups, num_pages+1, page_size, KV, hd] walked
    through block_tab [B, pages_per_slot] with per-row lengths. The "ref"
    backend gathers the paged view first (the materialization the kernel
    avoids)."""
    if check_backend(backend) == "ref":
        return kref.decode_paged_ref(q1, k_pool, v_pool, block_tab, lengths,
                                     layer=layer)
    return flash_decode_paged(q1, k_pool, v_pool, block_tab, lengths,
                              layer=layer)


def rwkv6(r, k, v, w, u, *, backend=None):
    """Kernel layout: r,k,v,w [B,H,S,hd] (w = log-decay <= 0), u [H,hd] ->
    (y [B,H,S,hd], final state [B,H,hd,hd] f32), from a zero state."""
    if check_backend(backend) == "ref":
        return kref.rwkv6_ref(r, k, v, w, u)
    return rwkv6_chunked(r, k, v, w, u)


def ssd(x, dt, B_, C_, a, *, backend=None):
    """Kernel layout: x [B,H,S,P], dt [B,H,S], B_/C_ [B,S,N], a [H] < 0 ->
    (y [B,H,S,P], final state [B,H,N,P] f32), from a zero state."""
    if check_backend(backend) == "ref":
        return kref.ssd_ref(x, dt, B_, C_, a)
    return ssd_chunked(x, dt, B_, C_, a)


def gmm(x, w, *, backend=None):
    """Grouped (expert-batched) matmul x [E,C,d] @ w [E,d,f] -> [E,C,f] in
    x's dtype, summed in f32."""
    if check_backend(backend) == "ref":
        return kref.gmm_ref(x, w)
    return grouped_matmul(x, w)
