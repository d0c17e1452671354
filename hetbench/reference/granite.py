"""granite-moe-1b-a400m in plain float32, from the equations in
hetbench/configs/granite-moe-1b-a400m.json: pre-RMS-norm layers of GQA
attention with split-half RoPE and a routed SwiGLU expert FFN under a
static capacity, a tied head.

`z` is weights.sizes(cfg, family); `prec` a prec.Prec (float32, or a
control)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from hetbench.reference.common import layers, rms, rope

NEG = -1e30


def capacity(T: int, E: int, K: int, cf: float) -> int:
    """Rows an expert takes in one call over T positions."""
    cap = int(max(K, round(T * K / E * cf)))
    return max(4, (cap + 3) // 4 * 4)


def moe(z, p, x, prec, aux=None):
    """Routed FFN over x [T, d] (every position of the call). Choices are
    ranked per expert in token-major (token, choice) order and those at or
    past the capacity are dropped. Appends the Switch load-balancing loss
    to `aux` when given."""
    T, d = x.shape
    E, K = z["E"], z["K"]
    probs = torch.softmax(x @ p["router"], dim=-1)
    top, idx = torch.topk(probs, K, dim=-1)
    w = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = idx.reshape(-1)
    hot = F.one_hot(flat, E)
    rank = ((hot.cumsum(0) - hot) * hot).sum(-1)
    keep = rank < capacity(T, E, K, z["cf"])
    if aux is not None:
        fe = hot.view(T, K, E).sum(1).float().mean(0)
        aux.append(E * (probs.mean(0) * fe).sum())
    wk = (w.reshape(-1) * keep).view(T, K)
    out = x.new_zeros((T, d))
    for e in range(E):
        sel = torch.nonzero((flat == e) & keep).squeeze(1)
        if sel.numel() == 0:
            continue
        tok = sel // K
        h = prec.mm(x[tok], p["moe_w_in"][e].reshape(d, -1))
        h = h.view(-1, 2, z["ff"])
        y = prec.mm(F.silu(h[:, 0]) * h[:, 1], p["moe_w_out"][e])
        out = out.index_add(0, tok, y * wk.reshape(-1)[sel][:, None])
    return out


def attend(q, k, v, valid, prec):
    """Softmax attention of q [b, H, sq, hd] over k, v [b, H, sk, hd] where
    valid [b|1, 1, sq|1, sk] holds; a row with no valid key gives 0."""
    s = prec.left(q) @ prec.right(k.transpose(-1, -2))
    s = torch.where(valid, s * q.shape[-1] ** -0.5, NEG)
    m = s.amax(-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    o = prec.left(e) @ prec.right(v)
    return o / e.sum(-1, keepdim=True).clamp_min(1e-30)


def causal(z, q, k, v, prec, budget=1 << 27):
    """Causal attention over whole rows: q [B, S, H, hd], k / v [B, S, KV,
    hd] -> [B, S, H, hd], in blocks of rows and queries."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kx = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vx = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    qc = min(S, max(1, budget // (H * S)))
    rb = max(1, budget // (H * S * qc))
    pos = torch.arange(S, device=q.device)
    out = []
    for b0 in range(0, B, rb):
        rows = []
        for q0 in range(0, S, qc):
            q1 = min(S, q0 + qc)
            valid = (pos[None, :q1] <= pos[q0:q1, None])[None, None]
            rows.append(attend(qt[b0:b0 + rb, :, q0:q1], kx[b0:b0 + rb, :, :q1],
                               vx[b0:b0 + rb, :, :q1], valid, prec))
        out.append(torch.cat(rows, dim=2))
    return torch.cat(out).transpose(1, 2)


def qkv(z, p, xn, pos, prec):
    B, S, _ = xn.shape
    H, KV, hd = z["H"], z["KV"], z["hd"]
    q = prec.mm(xn, p["wq"]).view(B, S, H, hd)
    k = prec.mm(xn, p["wk"]).view(B, S, KV, hd)
    v = prec.mm(xn, p["wv"]).view(B, S, KV, hd)
    return rope(q, pos, z["theta"]), rope(k, pos, z["theta"]), v


def logits(z, params, h, prec):
    """Logits over the real vocabulary of final hidden states h [n, d]."""
    hn = rms(h, params["final_norm"], z["eps"])
    return prec.mm(hn, params["embed"].T)[:, :z["vocab"]]


def prefill(z, params, tokens, lens, prec, kv_rows=()):
    """One admission group as the Scheduler batches it: tokens [B, P]
    (right-padded rows, idle rows included), lens [B]. Every position
    routes and takes capacity. Returns (logits [B, vocab] at each row's
    last real position, {layer: (k, v)} of the rows in kv_rows, [n, P,
    KV, hd], the K/V the cache would hold)."""
    B, P = tokens.shape
    x = params["embed"][tokens.long()].float()
    pos = torch.arange(P, device=x.device)
    kv = {}
    for l, p in enumerate(layers(params)):
        xn = rms(x, p["ln1"], z["eps"])
        q, k, v = qkv(z, p, xn, pos, prec)
        if len(kv_rows):
            kv[l] = (k[list(kv_rows)], v[list(kv_rows)])
        o = causal(z, q, k, v, prec).reshape(B, P, -1)
        x = x + prec.mm(o, p["wo"])
        xn = rms(x, p["ln2"], z["eps"]).reshape(B * P, -1)
        x = x + moe(z, p, xn, prec).view(B, P, -1)
    last = x[torch.arange(B, device=x.device), lens.long() - 1]
    return logits(z, params, last, prec), kv


def decode(z, params, toks, pos, tab, k_pool, v_pool, prec):
    """One decode step of the whole batch from a paged cache: toks, pos
    [B]; tab [B, pages] the block table (-1 unmapped); pools [L, pages+1,
    page, KV, hd] holding every earlier position. Positions on unmapped
    pages are not read, so an idle row (no page) attends to nothing.
    Returns (logits [B, vocab], k, v [L, B, KV, hd] of the new position)."""
    B = toks.shape[0]
    ps = k_pool.shape[2]
    dev = toks.device
    x = params["embed"][toks.long()].float()[:, None]
    live = tab[:, 0] >= 0
    ctx = int(pos[live].max()) + 1 if bool(live.any()) else 1
    npg = -(-ctx // ps)
    pages = tab[:, :npg].long()
    phys = torch.where(pages >= 0, pages, k_pool.shape[1] - 1)
    j = torch.arange(npg * ps, device=dev)
    mapped = (pages >= 0).repeat_interleave(ps, dim=1)
    valid = torch.cat([mapped & (j[None] < pos[:, None]), live[:, None]], 1)
    valid = valid[:, None, None, :]
    H, KV = z["H"], z["KV"]
    new_k, new_v = [], []
    for l, p in enumerate(layers(params)):
        xn = rms(x, p["ln1"], z["eps"])
        q, k, v = qkv(z, p, xn, pos[:, None], prec)
        new_k.append(k[:, 0])
        new_v.append(v[:, 0])
        kc = k_pool[l][phys].reshape(B, npg * ps, KV, -1).float()
        vc = v_pool[l][phys].reshape(B, npg * ps, KV, -1).float()
        kc = torch.cat([kc, k], 1).repeat_interleave(H // KV, dim=2)
        vc = torch.cat([vc, v], 1).repeat_interleave(H // KV, dim=2)
        o = attend(q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                   valid, prec)
        x = x + prec.mm(o.transpose(1, 2).reshape(B, 1, -1), p["wo"])
        xn = rms(x, p["ln2"], z["eps"]).reshape(B, -1)
        x = x + moe(z, p, xn, prec).view(B, 1, -1)
    return logits(z, params, x[:, 0], prec), torch.stack(new_k), \
        torch.stack(new_v)


def train_loss(z, p_all, inputs, labels, prec, chunk=512):
    """One microbatch's loss: the mean cross entropy (head product on
    bf16-rounded operands summed in float32, per chunk of positions) plus
    0.01 x the layers' load-balancing losses over the layer count."""
    B, S = inputs.shape
    x = p_all["embed"][inputs.long()].float()
    pos = torch.arange(S, device=x.device)
    aux = []
    for p in layers(p_all):
        xn = rms(x, p["ln1"], z["eps"])
        q, k, v = qkv(z, p, xn, pos, prec)
        x = x + prec.mm(causal(z, q, k, v, prec).reshape(B, S, -1), p["wo"])
        xn = rms(x, p["ln2"], z["eps"]).reshape(B * S, -1)
        x = x + moe(z, p, xn, prec, aux).view(B, S, -1)
    h = rms(x, p_all["final_norm"], z["eps"])
    head = p_all["embed"].T
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    col = torch.arange(head.shape[1], device=x.device)
    total = x.new_zeros(())
    for c0 in range(0, S, chunk):
        hc = h[:, c0:c0 + chunk].bfloat16().float()
        lg = prec.mm(hc, head.bfloat16().float())
        lg = torch.where(col < z["vocab"], lg, NEG)
        gold = lg.gather(-1, labels[:, c0:c0 + chunk, None].long())[..., 0]
        total = total + (torch.logsumexp(lg, -1) - gold).sum()
    return total / (B * S) + 0.01 * torch.stack(aux).sum() / len(aux)
