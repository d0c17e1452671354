"""granite-4.0-h-small in plain float32, from the equations in
hetbench/configs/granite-4.0-h-small.json: pre-RMS-norm layers whose mixer
is a Mamba-2 SSD (36 layers) or a GQA attention without position
embedding (4 layers), then a routed SwiGLU expert FFN under a static
capacity on this card's share of the experts plus a shared SwiGLU expert,
a tied head.

Its own Mamba-2 scan runs position by position (no chunks); attention and
the expert capacity rule are granite-moe's (reference/granite.py). The
weights are the port's tree: a leaf of one kind stacked over that kind's
layers only (`z["types"]` names each layer's kind), converted to float32
one layer at a time, so the reference fits beside the bfloat16 weights.
`z` is the family's sizes; `prec` a prec.Prec (float32, or a control)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from hetbench.reference.common import rms
from hetbench.reference.granite import attend, capacity, causal

ATTN = ("wq", "wk", "wv", "wo")


def layer(params, z, l) -> dict:
    """Layer l's leaves in float32: the leaves every layer has, and its
    kind's (indexed by l's place among that kind's layers)."""
    kind = z["types"][l]
    place = z["types"][:l].count(kind)
    out = {}
    for n, t in params["blocks"].items():
        mine = "attention" if n in ATTN else \
            "mamba" if n.startswith("ssd_") else None
        if mine is None:
            out[n] = t[l].float()
        elif mine == kind:
            out[n] = t[place].float()
    return out


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------
def conv(z, p, xbc, tail):
    """Causal depthwise conv of width 4 with bias over xbc [B, S, c], the
    three inputs before it in tail [B, 3, c]. Returns (out, the padded
    input [B, S + 3, c])."""
    c = xbc.shape[-1]
    xp = torch.cat([tail.float(), xbc], dim=1)
    w = p["ssd_conv_w"].T[:, None, :]                       # [c, 1, 4]
    out = F.conv1d(xp.transpose(1, 2), w, groups=c).transpose(1, 2)
    return out + p["ssd_conv_b"], xp


def mamba(z, p, xn, lens, prec, state=None, tail=None):
    """A Mamba-2 mixer over xn [B, S, d] from `state` [B, H, N, P] and the
    conv's `tail` [B, 3, c] (zeros: a fresh request). Position t of row b
    is real where t < lens[b]: past it the state and the tail stay as
    they are. Returns (y [B, S, d], state, tail)."""
    B, S, _ = xn.shape
    H, N, P, di = z["Hs"], z["N"], z["P"], z["di"]
    c = di + 2 * N
    if state is None:
        state = xn.new_zeros((B, H, N, P))
        tail = xn.new_zeros((B, 3, c))
    proj = prec.mm(xn, p["ssd_in_proj"])
    zg, xbc, dt = torch.split(proj, [di, c, H], dim=-1)
    xbc, xp = conv(z, p, xbc, tail)
    xbc = F.silu(xbc)
    x, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    x = x.reshape(B, S, H, P)
    dt = F.softplus(dt + p["ssd_dt_bias"])
    A = -torch.exp(p["ssd_A_log"])
    live = torch.arange(S, device=xn.device)[None] < lens[:, None]
    dt = torch.where(live[..., None], dt, 0.0)
    ys = []
    for t in range(S):                    # the recurrence, one position a step
        dA = torch.exp(dt[:, t] * A)                        # [B, H]
        inj = (dt[:, t, :, None, None] * Bm[:, t, None, :, None]
               * x[:, t, :, None, :])                       # [B, H, N, P]
        state = dA[..., None, None] * state + inj
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], state))
    y = torch.stack(ys, 1) + p["ssd_D"][:, None] * x
    y = y.reshape(B, S, di) * F.silu(zg)                    # gate, then norm
    y = rms(y, p["ssd_norm_scale"], z["eps"])
    # the tail: each row's last three real inputs (xp index t + 3 holds t)
    idx = lens.clamp(0, S)[:, None] + torch.arange(3, device=xn.device)
    tail = xp[torch.arange(B, device=xn.device)[:, None], idx]
    return prec.mm(y, p["ssd_out_proj"]), state, tail


# ---------------------------------------------------------------------------
# the FFN: this card's routed experts and the shared expert
# ---------------------------------------------------------------------------
def moe_share(z, p, x, prec):
    """The routed FFN's part from the experts held here, over x [T, d]
    (every position of the call): the router's softmax over all E_route
    experts, the top K renormalised; each choice ranked in its expert's
    queue in token-major (token, choice) order, those at or past the
    capacity (counted over all E_route experts) dropped; only experts
    [offset, offset + E) are computed, the others' part left out."""
    T, d = x.shape
    E, K, lo = z["E_route"], z["K_route"], z["offset"]
    probs = torch.softmax(x @ p["router"], dim=-1)          # f32, as served
    top, idx = torch.topk(probs, K, dim=-1)
    w = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = idx.reshape(-1)
    hot = F.one_hot(flat, E)
    rank = ((hot.cumsum(0) - hot) * hot).sum(-1)
    keep = rank < capacity(T, E, K, z["cf"])
    wk = (w.reshape(-1) * keep).view(T, K)
    out = x.new_zeros((T, d))
    for e in range(z["E"]):
        sel = torch.nonzero((flat == lo + e) & keep).squeeze(1)
        if sel.numel() == 0:
            continue
        tok = sel // K
        h = prec.mm(x[tok], p["moe_w_in"][e].reshape(d, -1)).view(-1, 2,
                                                                  z["ff"])
        y = prec.mm(F.silu(h[:, 0]) * h[:, 1], p["moe_w_out"][e])
        out = out.index_add(0, tok, y * wk.reshape(-1)[sel][:, None])
    return out


def shared(z, p, x, prec):
    """The shared SwiGLU expert over x [T, d]."""
    h = prec.mm(x, p["shared_wi"].reshape(z["d"], -1)).view(-1, 2, z["sff"])
    return prec.mm(F.silu(h[:, 0]) * h[:, 1], p["shared_wo"])


def ffn(z, p, x, prec):
    B, S, d = x.shape
    xn = rms(x, p["ln2"], z["eps"]).reshape(B * S, d)
    return (moe_share(z, p, xn, prec) + shared(z, p, xn, prec)).view(B, S, d)


def qkv(z, p, xn, prec):
    """Queries, keys and values without position embedding (NoPE)."""
    B, S, _ = xn.shape
    Ha, KVa, hd = z["Ha"], z["KVa"], z["hd"]
    return (prec.mm(xn, p["wq"]).view(B, S, Ha, hd),
            prec.mm(xn, p["wk"]).view(B, S, KVa, hd),
            prec.mm(xn, p["wv"]).view(B, S, KVa, hd))


def logits(z, params, h, prec):
    """Logits over the vocabulary of final hidden states h [n, d]."""
    hn = rms(h, params["final_norm"].float(), z["eps"])
    return prec.mm(hn, params["embed"].T)[:, :z["vocab"]]


def prefill(z, params, tokens, lens, prec, rows=()):
    """One admission group as the Scheduler batches it: tokens [B, P]
    (right-padded rows, idle rows included), lens [B]; every position
    routes and takes capacity. Returns (logits [B, vocab] at each row's
    last real position, {attention layer: (k, v) of `rows`}, {Mamba
    layer: (state, tail) of `rows`}), the K/V and state the cache would
    hold."""
    B, P = tokens.shape
    x = params["embed"][tokens.long()].float()
    rows = list(rows)
    kv, st = {}, {}
    for l, kind in enumerate(z["types"]):
        p = layer(params, z, l)
        xn = rms(x, p["ln1"], z["eps"])
        if kind == "attention":
            q, k, v = qkv(z, p, xn, prec)
            kv[l] = (k[rows], v[rows])
            o = causal(z, q, k, v, prec).reshape(B, P, -1)
            x = x + prec.mm(o, p["wo"])
        else:
            y, s, t = mamba(z, p, xn, lens.long(), prec)
            st[l] = (s[rows], t[rows])
            x = x + y
        x = x + ffn(z, p, x, prec)
        del p
    last = x[torch.arange(B, device=x.device), lens.long() - 1]
    return logits(z, params, last, prec), kv, st


def decode(z, params, toks, pos, tab, k_pool, v_pool, ssm_state, conv_tail,
           prec, rows=()):
    """One decode step of the whole batch from the cache as the program
    holds it: toks, pos [B]; tab [B, pages] the block table (-1
    unmapped); k/v pools [4, pages + 1, page, KV, hd] of the attention
    layers holding every earlier position; ssm_state [36, B, H, N, P] and
    conv_tail [36, B, 3, c] of the Mamba layers, before the step (not
    modified). Returns (logits [B, vocab], k, v [4, B, KV, hd] of the new
    position, {Mamba layer: (state, tail) of `rows` after the step})."""
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
    Ha, KVa = z["Ha"], z["KVa"]
    one = torch.ones(B, dtype=torch.long, device=dev)
    rows = list(rows)
    new_k, new_v, st = [], [], {}
    a = m = 0
    for l, kind in enumerate(z["types"]):
        p = layer(params, z, l)
        xn = rms(x, p["ln1"], z["eps"])
        if kind == "attention":
            q, k, v = qkv(z, p, xn, prec)
            new_k.append(k[:, 0])
            new_v.append(v[:, 0])
            kc = k_pool[a][phys].reshape(B, npg * ps, KVa, -1).float()
            vc = v_pool[a][phys].reshape(B, npg * ps, KVa, -1).float()
            kc = torch.cat([kc, k], 1).repeat_interleave(Ha // KVa, dim=2)
            vc = torch.cat([vc, v], 1).repeat_interleave(Ha // KVa, dim=2)
            o = attend(q.transpose(1, 2), kc.transpose(1, 2),
                       vc.transpose(1, 2), valid, prec)
            x = x + prec.mm(o.transpose(1, 2).reshape(B, 1, -1), p["wo"])
            a += 1
        else:
            y, s, t = mamba(z, p, xn, one, prec, ssm_state[m].float(),
                            conv_tail[m].float())
            st[l] = (s[rows], t[rows])
            x = x + y
            m += 1
        x = x + ffn(z, p, x, prec)
        del p
    return logits(z, params, x[:, 0], prec), torch.stack(new_k), \
        torch.stack(new_v), st
