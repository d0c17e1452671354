"""SSM mixers: the RWKV6 (Finch) time-mix, data-dependent per-channel
decay, and the Mamba-2 style SSD of the hybrid (hymba) family, one decay
scalar per head.

RWKV6 per head (state S in R^{K x V}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with w_t = exp(-exp(clip(w0 + lora(x)))).

SSD per head (state h in R^{N x P}):
    h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T
    y_t = h_t^T C_t + D x_t
then a gated RMS norm over d_inner: hymba's norm(y) * silu(z), or
Mamba-2's norm(y * silu(z)) (gate_norm); Mamba-2's conv has a bias.

Prefill starts from a zero state and runs a chunked form (the plain "ref"
path: the chunked torch scans the JAX package runs; with
kernel_backend="cuda", the rwkv6_chunked and ssd_chunked Hopper kernels);
decode runs the single-token steps in plain torch (the JAX package has no
kernel for them either). f32 state and accumulation throughout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import rms_norm

# decay-rate clamp keeping exp(-cs) representable for chunk <= 16: the
# per-step log-decay lies in [-4, 0)
_LOGW_CLIP = (-8.0, 1.386)  # max per-step rate e^1.386 = 4.0
_CHUNK = 16                 # the plain scan's chunk (the kernel's too)
_SSD_CHUNK = 64             # the plain SSD scan's largest chunk (the kernel's)


def rwkv6_decay(x, w0, wa, wb):
    """Per-channel log-decay (<= 0): -exp(clip(w0 + tanh(x wa) wb))."""
    lora = torch.tanh(x.float() @ wa.float())
    raw = w0.float() + lora @ wb.float()
    return -torch.exp(raw.clamp(*_LOGW_CLIP))


def _shift(x, prev):
    """Token shift: returns x_{t-1} with prev (or zeros) for t=0. x [B,S,d]."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv6_projections(p, xx, prev_xx, heads):
    """Token-shifted projections. xx [B,S,d] (post-ln). Returns r,k,v,g,logw
    with r/k/v/logw [B,S,H,hd]."""
    B, S, d = xx.shape
    hd = d // heads
    xp = _shift(xx, prev_xx)

    def mix(mu):
        return xx + mu * (xp - xx)

    r = (mix(p["mu_r"]) @ p["wr"]).reshape(B, S, heads, hd)
    k = (mix(p["mu_k"]) @ p["wk"]).reshape(B, S, heads, hd)
    v = (mix(p["mu_v"]) @ p["wv"]).reshape(B, S, heads, hd)
    g = F.silu(mix(p["mu_g"]) @ p["wg"])
    logw = rwkv6_decay(mix(p["mu_w"]), p["w0"], p["wa"], p["wb"])
    return r, k, v, g, logw.reshape(B, S, heads, hd)


def _rwkv_head_out(p, y, g, heads):
    """Per-head group norm (population variance, eps 64e-5), gating and the
    output projection. y [B,S,H,hd] f32."""
    B, S, H, hd = y.shape
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    yn = (y - mu) * torch.rsqrt(var + 64e-5)
    yn = yn.reshape(B, S, H * hd) * p["gn_scale"] + p["gn_bias"]
    return (yn * g).to(p["wo"].dtype) @ p["wo"]


def _last_real(xx, lens):
    """Each row's last real token [B,1,d]: position lens-1, or the last."""
    if lens is None:
        return xx[:, -1:]
    idx = (lens - 1).clamp_min(0).long()
    return xx[torch.arange(xx.shape[0], device=xx.device), idx][:, None]


def wkv6_chunked_scan(r, k, v, logw, u):
    """The plain WKV6 scan in chunks of _CHUNK (the largest divisor of S up
    to it, as the JAX package picks), from a zero state, in f32. r, k, v,
    logw [B,S,H,hd]; u [H,hd]. Returns y [B,S,H,hd] f32 and the final state
    [B,H,hd,hd] f32."""
    B, S, H, hd = r.shape
    C = min(_CHUNK, S)
    while S % C:
        C -= 1
    n = S // C

    def chz(a):   # [B,S,H,x] -> [n,B,C,H,x]
        return a.float().reshape(B, n, C, *a.shape[2:]).transpose(0, 1)

    rc, kc, vc, wc = map(chz, (r, k, v, logw))
    u = u.float()
    tri = torch.tril(torch.ones((C, C), device=r.device), diagonal=-1)
    st = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for i in range(n):
        r_, k_, v_, w_ = rc[i], kc[i], vc[i], wc[i]         # [B,C,H,*]
        cs = torch.cumsum(w_, dim=1)                        # [B,C,H,K] (<=0)
        cs_prev = cs - w_                                   # cs_{t-1} (cs_0 = 0)
        r_p = r_ * torch.exp(cs_prev)
        k_p = k_ * torch.exp(-cs)
        scores = torch.einsum("bthi,bshi->bhts", r_p, k_p) * tri
        diag = torch.einsum("bthi,hi,bthi->bth", r_, u, k_)  # u-bonus on t==s
        y = torch.einsum("bhts,bshj->bthj", scores, v_)
        y = y + diag[..., None] * v_
        y = y + torch.einsum("bthi,bhij->bthj", r_p, st)     # inter-chunk
        st = torch.exp(cs[:, -1])[..., None] * (
            st + torch.einsum("bshi,bshj->bhij", k_p, v_))
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, hd), st


def rwkv6_mix(p, xx, *, heads: int, lens=None, kernel_backend="ref"):
    """RWKV6 time-mix of a prefill from a fresh state. xx [B,S,d]. Returns
    y, final_state, last_xx.

    lens [B] (optional): per-row valid prefix for right-padded variable-
    length prompts. Padded positions are made a state no-op (k = 0,
    decay = 1, so S_t = S_{t-1}) and last_xx is the last *real* token per
    row; y at padded positions is garbage and must not be read.

    kernel_backend="cuda" routes the recurrence through the rwkv6_chunked
    kernel; "ref" runs wkv6_chunked_scan."""
    B, S, d = xx.shape
    r, k, v, g, logw = rwkv6_projections(p, xx, None, heads)
    if lens is not None:
        live = (torch.arange(S, device=xx.device)[None, :]
                < lens[:, None])[..., None, None]
        k = torch.where(live, k, 0.0)
        logw = torch.where(live, logw, 0.0)
    if kernel_backend == "ref":
        y, st = wkv6_chunked_scan(r, k, v, logw, p["u"])
    else:
        # [B, S, H, hd] memory handed over as [B, H, S, hd] views, uncopied
        y4, st = kernel_ops.rwkv6(
            *(a.float().transpose(1, 2) for a in (r, k, v, logw)),
            p["u"].float(), backend=kernel_backend)
        y = y4.transpose(1, 2).float()
    out = _rwkv_head_out(p, y, g, heads)
    return out.to(xx.dtype), st, _last_real(xx, lens)


def rwkv6_mix_step(p, xx, state, prev_xx, *, heads: int):
    """Single-token RWKV6 step. xx [B,1,d]; state [B,H,hd,hd] f32."""
    B, _, d = xx.shape
    hd = d // heads
    r, k, v, g, logw = rwkv6_projections(p, xx, prev_xx, heads)
    r, k, v, w = (a[:, 0].float() for a in (r, k, v, logw))
    u = p["u"].float()
    kv = k[..., :, None] * v[..., None, :]                  # [B,H,hd,hd]
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    state = torch.exp(w)[..., None] * state + kv
    out = _rwkv_head_out(p, y.reshape(B, 1, heads, hd), g, heads)
    return out.to(xx.dtype), state, xx


# ----------------------------------------------------------------------------
# SSD (Mamba-2 style), one decay scalar per head
# ----------------------------------------------------------------------------
def _dw_conv4(x, w, tail=None, lens=None):
    """Causal depthwise conv, kernel 4, via shifts. x [B,S,c]; w [4,c];
    tail [B,3,c] the previous inputs (decode continuity). Returns (out,
    the new tail): the last three inputs, or with lens [B] each row's last
    three inputs *before* position lens[b] (right-padded prefill)."""
    B, S, c = x.shape
    if tail is None:
        tail = x.new_zeros((B, 3, c))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)        # [B, S+3, c]
    out = sum(xp[:, 3 - i: 3 - i + S] * w[3 - i] for i in range(4))
    if lens is None:
        return out, xp[:, -3:]
    # xp index t+3 holds input position t: a row's last real inputs sit at
    # xp indices lens[b] .. lens[b]+2
    idx = lens.clamp(0, S)[:, None] + torch.arange(3, device=x.device)
    return out, xp[torch.arange(B, device=x.device)[:, None], idx]


def ssd_projections(p, x, heads, d_inner, d_state, conv_tail=None,
                    lens=None):
    """in_proj + conv + activations. x [B,S,d]. Returns z, xh [B,S,H,P],
    Bm, Cm [B,S,N], dt [B,S,H] f32, the conv tail."""
    B, S, _ = x.shape
    H, N = heads, d_state
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    xbc, tail = _dw_conv4(xbc, p["conv_w"].to(x.dtype), conv_tail, lens=lens)
    if "conv_b" in p:
        xbc = xbc + p["conv_b"].to(x.dtype)
    xbc = F.silu(xbc)
    xh, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return z, xh.reshape(B, S, H, d_inner // H), Bm, Cm, dt, tail


def _gated_norm(p, y, z, gate_norm: bool, eps: float):
    """The gated RMS norm over d_inner: norm(y) * silu(z), or with
    gate_norm Mamba-2's norm(y * silu(z)) (the gate in f32)."""
    if gate_norm:
        return rms_norm(y.float() * F.silu(z.float()), p["norm_scale"],
                        eps=eps)
    return rms_norm(y, p["norm_scale"], eps=eps) * F.silu(z)


def _ssd_out(p, x, y, xh, z, d_inner, gate_norm=False, eps=1e-6):
    """The SSD output tail: D-skip, gated RMS norm, out projection.
    y/xh [B,S,H,P]."""
    B, S = x.shape[:2]
    y = y.float() + p["D"].float()[None, None, :, None] * xh.float()
    y = _gated_norm(p, y.reshape(B, S, d_inner), z, gate_norm, eps)
    out = y.to(p["out_proj"].dtype) @ p["out_proj"]
    return out.to(x.dtype)


def ssd_chunked_scan(xh, dt, Bm, Cm, a):
    """The plain SSD scan in chunks of _SSD_CHUNK (the largest divisor of S
    up to it, as the JAX package picks), from a zero state, in f32. xh
    [B,S,H,P]; dt [B,S,H]; Bm, Cm [B,S,N]; a [H] < 0. Returns y [B,S,H,P]
    f32 and the final state [B,H,N,P] f32."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    C = min(_SSD_CHUNK, S)
    while S % C:
        C -= 1
    n = S // C

    def chz(t):   # [B,S,...] -> [n,B,C,...]
        return t.float().reshape(B, n, C, *t.shape[2:]).transpose(0, 1)

    xc, Bc, Cc, dtc = map(chz, (xh, Bm, Cm, dt))
    tril = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    ys = []
    for i in range(n):
        x_, B_, C_, dt_ = xc[i], Bc[i], Cc[i], dtc[i]
        cs = torch.cumsum(dt_ * a, dim=1)                   # [B,C,H] <= 0
        # intra-chunk: M[t,s] = (C_t . B_s) exp(cs_t - cs_s) dt_s, s <= t
        cb = torch.einsum("btn,bsn->bts", C_, B_)
        L = torch.where(tril, torch.exp(cs[:, :, None] - cs[:, None]), 0.0)
        M = cb[..., None] * L * dt_[:, None]                # [B,t,s,H]
        y = torch.einsum("btsh,bshp->bthp", M, x_)
        # inter-chunk: y_t += (C_t exp(cs_t)) . h
        y = y + torch.einsum("btn,bhnp->bthp", C_, h) * \
            torch.exp(cs)[..., None]
        w = torch.exp(cs[:, -1:] - cs) * dt_                # [B,C,H]
        h = torch.exp(cs[:, -1])[..., None, None] * h + torch.einsum(
            "bsn,bshp->bhnp", B_, w[..., None] * x_)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, P), h


def ssd_mix(p, x, *, heads: int, d_state: int, d_inner: int, lens=None,
            kernel_backend="ref", gate_norm=False, eps=1e-6):
    """The SSD mix of a prefill from a fresh state. x [B,S,d]. Returns y
    [B,S,d], the final state [B,H,N,P] f32 and the conv tail.

    lens [B] (optional): per-row valid prefix for right-padded variable-
    length prompts. Padded positions are a state no-op (dt = 0, so
    h_t = h_{t-1}) and the conv tail holds each row's last three *real*
    inputs; y at padded positions is garbage and must not be read.

    kernel_backend="cuda" routes the recurrence through the ssd_chunked
    kernel; "ref" runs ssd_chunked_scan."""
    B, S, d = x.shape
    H, N = heads, d_state
    z, xh, Bm, Cm, dt, tail = ssd_projections(p, x, H, d_inner, N,
                                              lens=lens)
    if lens is not None:
        live = torch.arange(S, device=x.device)[None, :] < lens[:, None]
        dt = torch.where(live[..., None], dt, 0.0)
    a = -torch.exp(p["A_log"].float())                      # [H], < 0
    if kernel_backend == "ref":
        y, st = ssd_chunked_scan(xh, dt, Bm, Cm, a)
    else:
        # column slices of the conv output and [B, S, H] memory handed
        # over as [B, H, S, *] views, uncopied (in f32)
        y4, st = kernel_ops.ssd(xh.float().transpose(1, 2),
                                dt.transpose(1, 2), Bm.float(), Cm.float(),
                                a, backend=kernel_backend)
        y = y4.transpose(1, 2)
    return _ssd_out(p, x, y, xh, z, d_inner, gate_norm, eps), st, tail


def ssd_mix_step(p, x, state, conv_tail, *, heads: int, d_state: int,
                 d_inner: int, gate_norm=False, eps=1e-6):
    """Single-token SSD step. x [B,1,d]; state [B,H,N,P] f32; conv_tail
    [B,3,d_inner+2N]. Returns y, the new state and the new conv tail."""
    B = x.shape[0]
    H, N = heads, d_state
    z, xh, Bm, Cm, dt, tail = ssd_projections(p, x, H, d_inner, N, conv_tail)
    a = -torch.exp(p["A_log"].float())
    x0 = xh[:, 0].float()                                   # [B,H,P]
    B0, C0 = Bm[:, 0].float(), Cm[:, 0].float()             # [B,N]
    inj = B0[:, None, :, None] * (dt[:, 0, :, None] * x0)[:, :, None, :]
    state = torch.exp(dt[:, 0] * a)[..., None, None] * state + inj
    y = torch.einsum("bn,bhnp->bhp", C0, state)
    y = y + p["D"].float()[None, :, None] * x0
    y = _gated_norm(p, y.reshape(B, 1, d_inner), z, gate_norm, eps)
    out = y.to(p["out_proj"].dtype) @ p["out_proj"]
    return out.to(x.dtype), state, tail
