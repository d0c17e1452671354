"""Family `moe`: decoder layers of GQA attention with RoPE and a routed
SwiGLU expert FFN under a static capacity (granite-moe). The plain
reference is reference/granite.py."""
from __future__ import annotations

import math

import torch

from hetbench import weights
from hetbench.reference import compare, granite, prec

train_loss = granite.train_loss


def sizes(f: dict) -> dict:
    return {"H": int(f["num_heads"]), "KV": int(f["num_kv_heads"]),
            "hd": int(f["head_dim"]), "E": int(f["num_experts"]),
            "K": int(f["top_k"]), "cf": float(f["capacity_factor"]),
            "theta": float(f["rope_theta"])}


def block_specs(z: dict) -> dict:
    d, ff, H, KV, hd, E = z["d"], z["ff"], z["H"], z["KV"], z["hd"], z["E"]
    out_scale = 0.02 / math.sqrt(2 * z["L"])
    return {"ln1": ((d,), "normal", 0.02), "ln2": ((d,), "normal", 0.02),
            "wq": ((d, H * hd), "normal", 0.02),
            "wk": ((d, KV * hd), "normal", 0.02),
            "wv": ((d, KV * hd), "normal", 0.02),
            "wo": ((H * hd, d), "normal", out_scale),
            "router": ((d, E), "normal", 0.02),
            "moe_w_in": ((E, d, 2, ff), "normal", 0.02),
            "moe_w_out": ((E, ff, d), "normal", out_scale)}


def matmul_params(z) -> float:
    """Weights one token multiplies through: attention, the router, top_k
    experts, the head (the embedding lookup excluded)."""
    d, H, KV, hd = z["d"], z["H"], z["KV"], z["hd"]
    per = (d * (H + 2 * KV) * hd + H * hd * d + d * z["E"]
           + z["K"] * (d * 2 * z["ff"] + z["ff"] * d))
    return float(z["L"] * per + d * z["vocab"])


def token_flops(z, pos: int) -> float:
    """Forward FLOPs of one token at position pos (causal context pos + 1)."""
    return 2.0 * matmul_params(z) + z["L"] * 4.0 * z["H"] * z["hd"] * (pos + 1)


def prompt_flops(z, L: int) -> float:
    """Forward FLOPs of a prompt of L real tokens."""
    return 2.0 * matmul_params(z) * L \
        + z["L"] * 4.0 * z["H"] * z["hd"] * L * (L + 1) / 2


def train_flops(z, rows: int, seq: int) -> float:
    """Model FLOPs of a training wave: 6 x the matmul weights a token, plus
    3 x causal attention's forward FLOPs."""
    attn = z["L"] * 4.0 * z["H"] * z["hd"] * seq * (seq + 1) / 2
    return rows * (6.0 * matmul_params(z) * seq + 3.0 * attn)


def check_serve(ctx, z, reqs, seen, mode):
    """Paged-cache MoE serving, judged step by step: the first admission
    group from scratch (its served first tokens' logit gap, its logits,
    two rows' K/V as the pages hold them), then the last decode step from
    the program's own pages (its tokens' logit gap, its logits, the K/V it
    wrote). MoE capacity couples every row of a call, so the reference
    recomputes whole calls."""
    mix, dev = ctx.mix, ctx.device
    first, store = seen.first, seen.store
    B, P = int(mix["max_batch"]), int(mix["prompt_len"])
    W = weights.make(ctx.cfg, ctx.seed, dtype=torch.bfloat16, device=dev,
                     family=ctx.cell.family)
    n0 = len(first["lens"])
    toks = torch.zeros((B, P), dtype=torch.long, device=dev)
    lens = torch.ones(B, dtype=torch.long, device=dev)
    for j, r in enumerate(reqs[:n0]):
        toks[j, :len(r.prompt)] = torch.as_tensor(r.prompt, device=dev)
        lens[j] = len(r.prompt)
    rows = sorted(first["snap"])
    served = torch.as_tensor(seen.steps[0][[first["slots"][j]
                                            for j in range(n0)]], device=dev)
    checks, control = {}, {}
    with prec.exact_f32():
        ref, kv = granite.prefill(z, W, toks, lens, prec.Prec(), rows)
        checks["gap_prefill"] = compare.logit_gap(ref[:n0], served)
        checks["logits_prefill"] = compare.rel_err(
            first["logits"][:n0, :z["vocab"]], ref[:n0])
        errs = []
        for i, j in enumerate(rows):
            n = int(lens[j])
            for got, l_ref in zip(first["snap"][j], (0, 1)):
                got = got.reshape(got.shape[0], -1, *got.shape[3:])[:, :n]
                want = torch.stack([kv[l][l_ref][i, :n] for l in sorted(kv)])
                errs.append(compare.rel_err(got, want))
        checks["kv_prefill"] = max(errs)
        if mode:
            lo, kv_lo = granite.prefill(z, W, toks, lens, prec.Prec(mode),
                                        rows)
            control["gap_prefill"] = compare.logit_gap(
                ref[:n0], lo[:n0].argmax(-1))
            control["logits_prefill"] = compare.rel_err(lo[:n0], ref[:n0])
            control["kv_prefill"] = max(
                compare.rel_err(kv_lo[l][s][i], kv[l][s][i])
                for l in kv for s in (0, 1) for i in range(len(rows)))
            del lo, kv_lo
        del ref, kv
        t_np, p_np, tab, logits = seen.last
        t = torch.as_tensor(t_np, device=dev)
        p = torch.as_tensor(p_np, device=dev)
        kp, vp = store.tree["kv_full"]
        ref, nk, nv = granite.decode(z, W, t, p, tab, kp, vp, prec.Prec())
        live = tab[:, 0] >= 0
        logits = logits[:, :z["vocab"]]
        checks["gap_decode"] = compare.logit_gap(ref[live],
                                                 logits[live].argmax(-1))
        checks["logits_decode"] = compare.rel_err(logits[live], ref[live])
        ps = kp.shape[2]
        b = torch.nonzero(live).squeeze(1)
        page, off = tab[b, p[b] // ps].long(), p[b] % ps
        checks["kv_decode"] = max(
            compare.rel_err(kp[:, page, off], nk[:, b]),
            compare.rel_err(vp[:, page, off], nv[:, b]))
        if mode:
            lo, lk, lv = granite.decode(z, W, t, p, tab, kp, vp,
                                        prec.Prec(mode))
            control["gap_decode"] = compare.logit_gap(ref[live],
                                                      lo[live].argmax(-1))
            control["logits_decode"] = compare.rel_err(lo[live], ref[live])
            control["kv_decode"] = max(compare.rel_err(lk[:, b], nk[:, b]),
                                       compare.rel_err(lv[:, b], nv[:, b]))
    return checks, control
