"""Attention: the plain blocked (flash-style) paths of kernel_backend="ref".

The kernels in repro_torch.kernels compute the same math; all softmax
accumulation is f32.

Layouts: q [B, S, H, hd]; k, v [B, S, KV, hd]; GQA group G = H // KV.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pick_block(s: int, want: int) -> int:
    b = min(want, s)
    while s % b:
        b -= 1
    return b


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_block: int = 256, kv_block: int = 512,
                    q_offset: int = 0):
    """Online-softmax attention, tiled over q and kv blocks.

    window > 0 restricts to keys with (qpos - kpos) < window (sliding
    window); q_offset is the global position of q[0] (kv starts at 0).
    Masked causal blocks are still computed, as in the JAX reference path.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qb = _pick_block(Sq, q_block)
    kb = _pick_block(Sk, kv_block)
    nq, nk = Sq // qb, Sk // kb
    scale = hd ** -0.5
    dev = q.device

    # [B, nq, qb, KV, G, hd] -> [nq, B, KV, G, qb, hd]
    qr = q.reshape(B, nq, qb, KV, G, hd).permute(1, 0, 3, 4, 2, 5).float()
    kr = k.reshape(B, nk, kb, KV, hd).permute(1, 0, 3, 2, 4).float()
    vr = v.reshape(B, nk, kb, KV, hd).permute(1, 0, 3, 2, 4).float()

    outs = []
    for qi in range(nq):
        gq = q_offset + qi * qb + torch.arange(qb, device=dev)
        m = torch.full((B, KV, G, qb), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, qb), device=dev)
        acc = torch.zeros((B, KV, G, qb, hd), device=dev)
        for kj in range(nk):
            gk = kj * kb + torch.arange(kb, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qr[qi], kr[kj]) * scale
            mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if causal:
                mask &= gq[:, None] >= gk[None, :]
            if window > 0:
                mask &= (gq[:, None] - gk[None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vr[kj])
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    # [nq, B, KV, G, qb, hd] -> [B, Sq, H, hd]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def banded_attention(q, k, v, *, window: int, q_block: int = 256):
    """Sliding-window causal attention with work proportional to S *
    (window + q block): each q block attends to the contiguous kv band
    [start, start + window + qb) sliced out of k/v, not the whole masked
    sequence. Falls back to flash_attention(window=) when the band covers
    all of Sk."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qb = _pick_block(Sq, q_block)
    nq = Sq // qb
    band = window + qb
    if band >= Sk:
        return flash_attention(q, k, v, causal=True, window=window,
                               q_block=q_block)
    scale = hd ** -0.5
    dev = q.device
    qr = q.reshape(B, nq, qb, KV, G, hd).permute(1, 0, 3, 4, 2, 5).float()
    kt = k.transpose(1, 2).float()                 # [B, KV, Sk, hd]
    vt = v.transpose(1, 2).float()
    outs = []
    for qi in range(nq):
        q0 = qi * qb
        start = min(max(q0 + qb - band, 0), Sk - band)
        k_b = kt[:, :, start:start + band]
        v_b = vt[:, :, start:start + band]
        gq = q0 + torch.arange(qb, device=dev)
        gk = start + torch.arange(band, device=dev)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qr[qi], k_b) * scale
        mask = (gq[:, None] >= gk[None, :]) & \
            ((gq[:, None] - gk[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out = torch.einsum("bkgqc,bkcd->bkgqd", p, v_b)
        outs.append(out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    # [nq, B, KV, G, qb, hd] -> [B, Sq, H, hd]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def decode_partial(q1, k_cache, v_cache, gpos, pos, *, window: int = 0):
    """The unnormalised softmax state of single-token attention against a
    KV cache (or one sequence shard of it): (o [B, KV, G, hd] f32, m, l
    [B, KV, G]) — the exp-weighted value sum, the running max (floored at
    NEG_INF / 2, so an empty shard contributes nothing) and the exp sum.

    q1 [B, 1, H, hd] (already roped at `pos`); k_cache/v_cache [B, Sc, KV,
    hd]; gpos [Sc] (or per-row [B, Sc]) global positions of the cached
    slots, -1 for unmapped ones; pos the current global position — a
    scalar or a [B] tensor (each row at its own depth).
    """
    B, _, H, hd = q1.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qr = q1.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bckd->bkgc", qr, k_cache.float()) * scale
    pos_b = torch.as_tensor(pos, device=q1.device)
    pos_b = pos_b[None] if pos_b.dim() == 0 else pos_b           # [1] or [B]
    gpos_b = torch.as_tensor(gpos, device=q1.device)
    gpos_b = gpos_b[None] if gpos_b.dim() == 1 else gpos_b       # [1|B, Sc]
    valid = (gpos_b <= pos_b[:, None]) & (gpos_b >= 0)
    if window > 0:
        valid &= (pos_b[:, None] - gpos_b) < window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m_safe = s.amax(dim=-1).clamp_min(NEG_INF / 2)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return o, m_safe, p.sum(dim=-1)


def merge_decode_partials(parts, q1):
    """Flash-decoding's logsumexp merge of decode_partial states over
    sequence shards (the JAX package's pmax / psum over its merge axis,
    launch.mesh's pmax / psum over data): each shard's o and l rescaled by
    exp(m - max m), summed, normalised.
    Returns [B, 1, H, hd] in q1's dtype; one part is decode_attend."""
    from repro_torch.launch import mesh as mesh_lib
    m_g = mesh_lib.pmax([m for _, m, _ in parts], axis="data")
    corr = [torch.exp(m_d - m_g) for _, m_d, _ in parts]
    dev = parts[0][0].device
    l = mesh_lib.psum([l_d * c for (_, _, l_d), c in zip(parts, corr)],
                      dev, axis="data")
    o = mesh_lib.psum([o_d * c[..., None]
                       for (o_d, _, _), c in zip(parts, corr)], dev,
                      axis="data")
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(q1.shape).to(q1.dtype)


def decode_attend(q1, k_cache, v_cache, gpos, pos, *, window: int = 0):
    """Single-token attention against a KV cache: decode_partial's state,
    normalised (see there for the arguments). Returns [B, 1, H, hd]."""
    B, _, H, hd = q1.shape
    o, _, l = decode_partial(q1, k_cache, v_cache, gpos, pos, window=window)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q1.dtype)
