"""The RWKV6 (Finch) time-mix: data-dependent per-channel decay.

Per head (state S in R^{K x V}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with w_t = exp(-exp(clip(w0 + lora(x)))).

Prefill starts from a zero state and runs a chunked form (the plain "ref"
path: the chunked torch scan the JAX package runs; with
kernel_backend="cuda", the rwkv6_chunked Hopper kernel); decode runs the
single-token step in plain torch (the JAX package has no kernel for it
either). f32 state and
accumulation throughout. The Mamba-2 SSD half of the JAX module comes with
the hybrid family (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops

# decay-rate clamp keeping exp(-cs) representable for chunk <= 16: the
# per-step log-decay lies in [-4, 0)
_LOGW_CLIP = (-8.0, 1.386)  # max per-step rate e^1.386 = 4.0
_CHUNK = 16                 # the plain scan's chunk (the kernel's too)


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
