"""Plain PyTorch versions of the Hopper kernels (the allclose targets).

Each function computes exactly what its Hopper kernel computes, with the
same masking and the same zero-length contract for attention (`l >=
1e-30`: a row with no live position returns zeros). On a CPU tensor the
kernel wrappers run these; on the card `chip_smoke.py` holds each kernel
against them.

Layouts (kernel-native):
  attention: q [B, H, Sq, hd]; k, v [B, KV, Sk, hd]  (GQA: G = H // KV)
  decode:    q1 [B, H, hd]; k, v [B, KV, S, hd]
  paged:     q1 [B, H, hd]; pools [groups, num_pages + 1, page_size, KV, hd]
  rwkv6:     r, k, v, w [B, H, S, hd] (w = log-decay <= 0); u [H, hd]
  ssd:       x [B, H, S, P]; dt [B, H, S] (>= 0); B_, C_ [B, S, N]; a [H] < 0
  gmm:       x [E, C, d]; w [E, d, f]
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _row_lengths(length, B: int, device) -> torch.Tensor:
    """Scalar or [B] -> [B] int32 per-row lengths on `device`."""
    lens = torch.as_tensor(length, dtype=torch.int32, device=device).reshape(-1)
    if lens.shape[0] not in (1, B):
        raise ValueError(f"length must be a scalar or a [B]={B} vector, got "
                         f"shape {tuple(lens.shape)}")
    return lens.expand(B)


def attention_ref(q, k, v, *, causal=True, window=0):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, hd)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k.float()) * hd ** -0.5
    gq = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # align ends
    gk = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= gq >= gk
    if window > 0:
        mask &= (gq - gk) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def decode_ref(q1, k, v, length, *, window=0):
    """q1 [B, H, hd]; k/v [B, KV, S, hd]; attend to positions < length
    (a scalar or a per-row [B] vector). Rows with length == 0 return
    zeros, not a uniform average over uninitialized V rows."""
    B, H, hd = q1.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qf = q1.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bkcd->bkgc", qf, k.float()) * hd ** -0.5
    pos = torch.arange(S, device=q1.device)[None, None, None, :]
    lens = _row_lengths(length, B, q1.device)[:, None, None, None]
    valid = pos < lens
    if window > 0:
        valid &= pos >= (lens - window)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgc,bkcd->bkgd", p / l, v.float())
    return o.reshape(B, H, hd).to(q1.dtype)


def decode_paged_ref(q1, k_pool, v_pool, block_tab, lengths, *, layer=0):
    """Gather the paged pool into a contiguous per-row view (exactly the
    materialization the paged kernel avoids), then run decode_ref with
    per-row lengths. block_tab [B, pages_per_slot] int32, -1 = unmapped
    (reads the trash page, the pool's last)."""
    B = q1.shape[0]
    _, P1, ps, KV, hd = k_pool.shape
    tab = block_tab.long()
    phys = torch.where(tab >= 0, tab, P1 - 1)                 # [B, npg]

    def view(pool):
        pages = pool[layer][phys]                             # [B,npg,ps,KV,hd]
        return pages.reshape(B, -1, KV, hd).transpose(1, 2)

    return decode_ref(q1, view(k_pool), view(v_pool), lengths, window=0)


def rwkv6_ref(r, k, v, w, u):
    """Sequential WKV6 recurrence from a zero state, one token at a time, in
    f32:
        y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    Returns (y [B,H,S,hd] in r's dtype, final state [B,H,hd,hd] f32)."""
    B, H, S, hd = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    st = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]     # [B,H,hd,hd]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, :, t], st + uf * kv))
        st = torch.exp(wf[:, :, t])[..., None] * st + kv
    y = torch.stack(ys, dim=2) if ys else rf.new_zeros((B, H, 0, hd))
    return y.to(r.dtype), st


def ssd_ref(x, dt, B_, C_, a):
    """Sequential SSD (Mamba-2, one decay scalar per head) from a zero
    state, one position at a time, in f32:
        h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T
        y_t = h_t^T C_t
    Returns (y [B,H,S,P] in x's dtype, final state [B,H,N,P] f32)."""
    B, H, S, P = x.shape
    N = B_.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, B_, C_))
    af = a.float()[None, :]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        d_t = dtf[:, :, t]                                   # [B,H]
        inj = bf[:, t, None, :, None] * (d_t[..., None] * xf[:, :, t])[
            :, :, None, :]                                   # [B,H,N,P]
        h = torch.exp(d_t * af)[..., None, None] * h + inj
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    y = torch.stack(ys, dim=2) if ys else xf.new_zeros((B, H, 0, P))
    return y.to(x.dtype), h


def gmm_ref(x, w):
    """Grouped (expert-batched) matmul [E, C, d] x [E, d, f] -> [E, C, f]:
    both operands widened to f32, f32 sums, one cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
