"""rwkv6-3b in plain float32, from the equations in
hetbench/configs/rwkv6-3b.json: per layer an RMS-normed time mix (static
token-shift mixes, data-dependent decay through a LoRA, the WKV
recurrence with its u bonus, a per-head group norm and a SiLU gate) and a
squared-ReLU channel mix; an untied head.

The recurrence runs in chunks of 16 positions: inside a chunk every pair
(t, s < t) is decayed by exp(cs_{t-1} - cs_s) directly (an exponent <= 0),
and the chunks hand on the state one after another."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from hetbench.reference.common import layers, rms

CHUNK = 16
LOGW_CLIP = (-8.0, 1.386)


def shift(x):
    """x_{t-1} along dim 0, zeros at t = 0. x [S, d]."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def wkv(r, k, v, logw, u):
    """r, k, v, logw [S, H, hd] float32; u [H, hd]. Returns y [S, H, hd]."""
    S, H, hd = r.shape
    n = -(-S // CHUNK)
    pad = n * CHUNK - S

    def chunks(a):     # [S, H, hd] -> [n, H, C, hd], padded with zeros
        a = torch.cat([a, a.new_zeros((pad, H, hd))]) if pad else a
        return a.view(n, CHUNK, H, hd).transpose(1, 2)

    r_, k_, v_, w_ = map(chunks, (r, k, v, logw))
    cs = w_.cumsum(2)
    prev = cs - w_
    t = torch.arange(CHUNK, device=r.device)
    before = (t[None, :] < t[:, None])[None, None, :, :, None]
    dec = torch.where(before, torch.exp(
        (prev[:, :, :, None] - cs[:, :, None]).clamp_max(0.0)), 0.0)
    score = (r_[:, :, :, None] * k_[:, :, None] * dec).sum(-1)
    y = score @ v_ + (r_ * u[None, :, None] * k_).sum(-1, keepdim=True) * v_
    kv_chunk = (k_ * torch.exp(cs[:, :, -1:] - cs)).transpose(-1, -2) @ v_
    state = r.new_zeros((H, hd, hd))
    starts = []
    for c in range(n):
        starts.append(state)
        state = torch.exp(cs[c, :, -1])[..., None] * state + kv_chunk[c]
    y = y + (r_ * torch.exp(prev)) @ torch.stack(starts)
    return y.transpose(1, 2).reshape(n * CHUNK, H, hd)[:S]


def forward(z, params, tokens, prec, at):
    """Logits [len(at), vocab] at positions `at` of one sequence of token
    ids [S], run from an empty state."""
    x = params["embed"][tokens.long()].float()
    S, d = x.shape
    H, hd = z["Hs"], z["hds"]
    for p in layers(params):
        xx = rms(x, p["ln1"], z["eps"])
        xp = shift(xx)

        def mix(mu):
            return xx + mu * (xp - xx)

        r = prec.mm(mix(p["mu_r"]), p["wr"]).view(S, H, hd)
        k = prec.mm(mix(p["mu_k"]), p["wk"]).view(S, H, hd)
        v = prec.mm(mix(p["mu_v"]), p["wv"]).view(S, H, hd)
        g = F.silu(prec.mm(mix(p["mu_g"]), p["wg"]))
        raw = p["w0"] + torch.tanh(mix(p["mu_w"]) @ p["wa"]) @ p["wb"]
        logw = -torch.exp(raw.clamp(*LOGW_CLIP)).view(S, H, hd)
        y = wkv(r, k, v, logw, p["u"])
        mu = y.mean(-1, keepdim=True)
        var = y.var(-1, keepdim=True, unbiased=False)
        yn = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(S, d)
        yn = yn * p["gn_scale"] + p["gn_bias"]
        x = x + prec.mm(yn * g, p["wo"])
        xx = rms(x, p["ln2"], z["eps"])
        xp = shift(xx)
        mk = xx + p["cm_mu_k"] * (xp - xx)
        mr = xx + p["cm_mu_r"] * (xp - xx)
        kk = F.relu(prec.mm(mk, p["cm_k"]))
        x = x + torch.sigmoid(prec.mm(mr, p["cm_r"])) * \
            prec.mm(kk * kk, p["cm_v"])
    h = rms(x[at], params["final_norm"], z["eps"])
    return prec.mm(h, params["head"])[:, :z["vocab"]]
