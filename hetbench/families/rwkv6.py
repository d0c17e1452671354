"""Family `rwkv6`: attention-free layers of the WKV6 time mix (data-dependent
decay through a LoRA) and a squared-ReLU channel mix, an untied head
(RWKV-6 Finch). The plain reference is reference/rwkv6.py. It serves
only: no training loss."""
from __future__ import annotations

import math

import numpy as np
import torch

from hetbench import weights
from hetbench.reference import compare, prec, rwkv6

LORA = 64          # the decay LoRA's rank


def sizes(f: dict) -> dict:
    return {"Hs": int(f["ssm_heads"]),
            "hds": int(f["d_model"]) // int(f["ssm_heads"])}


def block_specs(z: dict) -> dict:
    d, ff, Hs, hds = z["d"], z["ff"], z["Hs"], z["hds"]
    b = {"ln1": ((d,), "normal", 0.02), "ln2": ((d,), "normal", 0.02)}
    for n in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cm_mu_k", "cm_mu_r"):
        b[n] = ((d,), "uniform", (0.0, 1.0))
    for n in ("wr", "wk", "wv", "wg", "cm_r"):
        b[n] = ((d, d), "normal", 0.02)
    b.update({"wo": ((d, d), "normal", 0.02 / math.sqrt(2 * z["L"])),
              "w0": ((d,), "uniform", (-6.0, 0.0)),
              "wa": ((d, LORA), "normal", 0.02),
              "wb": ((LORA, d), "normal", 0.05),
              "u": ((Hs, hds), "uniform", (0.0, 1.0)),
              "gn_scale": ((d,), "one_plus", 0.02),
              "gn_bias": ((d,), "normal", 0.02),
              "cm_k": ((d, ff), "normal", 0.02),
              "cm_v": ((ff, d), "normal", 0.02 / math.sqrt(2 * z["L"]))})
    return b


def matmul_params(z) -> float:
    """Weights one token multiplies through: r, k, v, g, o, the channel
    mix, the decay LoRA, the head (the embedding lookup excluded)."""
    d = z["d"]
    per = 6 * d * d + 2 * d * LORA + 2 * d * z["ff"]
    return float(z["L"] * per + d * z["vocab"])


def token_flops(z, pos: int) -> float:
    """Forward FLOPs of one token (the WKV update costs the same at every
    position)."""
    return 2.0 * matmul_params(z) + z["L"] * 4.0 * z["Hs"] * z["hds"] ** 2


def prompt_flops(z, L: int) -> float:
    """Forward FLOPs of a prompt of L real tokens."""
    return L * token_flops(z, 0)


def _judged(seen, report, reqs):
    """The requests the check runs through the reference, by rid: the
    window's first admission group and the occupants of its last decode
    step. Each maps to its slot, admission step, row in the first group
    (or None), whether the last step fed it, its prompt and the tokens it
    was served: a retired request's are the report's, one still in flight
    has those fed to its slot since its admission."""
    admits = [a for ph, track, name, t, dur, a in seen.events
              if track == "sched" and name == "admit"]
    done = {r.rid: r for r in report.requests if not r.failed}
    occupant = {}
    for a in admits:
        occupant[a["slot"]] = a
    group0 = [a for a in admits if a["group"] == min(
        (b["group"] for b in admits), default=0)]
    _, pos, _, _ = seen.last
    out = {}
    for row, a in enumerate(group0):
        out[a["rid"]] = dict(slot=a["slot"], step=a["step"], row=row,
                             last=False)
    for s, a in occupant.items():
        if pos[s] > 0:
            out.setdefault(a["rid"], dict(slot=s, step=a["step"], row=None))
            out[a["rid"]]["last"] = True
    n = len(seen.steps)
    for rid, j in out.items():
        j["prompt"] = np.asarray(reqs[rid].prompt)
        if rid in done and not j["last"]:
            j["tokens"] = np.asarray(done[rid].tokens)
        else:
            j["tokens"] = np.asarray([seen.steps[i][j["slot"]]
                                      for i in range(j["step"], n)])
    return out


def check_serve(ctx, z, reqs, seen, mode):
    """Attention-free serving, judged request by request from an empty
    state: every request of the window's first admission group and every
    occupant of its last decode step, each run once through the reference
    over its prompt and the tokens it was served. Readings: gap_served,
    the widest gap by which a served token's reference logit lies below
    the reference's best; logits_prefill, the first group's prefill
    logits against the reference's at each prompt's end; logits_decode,
    the last decode step's logits of every live slot against the
    reference's at its position (both rms over the reference's rms)."""
    dev = ctx.device
    judged = _judged(seen, seen.report, reqs)
    _, pos, _, dec_logits = seen.last
    W = weights.make(ctx.cfg, ctx.seed, dtype=torch.bfloat16, device=dev,
                     family=ctx.cell.family)
    V = z["vocab"]
    pre_got, pre_ref, pre_lo, dec_got, dec_ref, dec_lo = ([] for _ in range(6))
    gap, gap_lo = 0.0, 0.0
    with prec.exact_f32():
        for rid, j in sorted(judged.items()):
            P, served = len(j["prompt"]), j["tokens"]
            n_served = len(served) if not j["last"] else len(served) + 1
            if j["last"] and P + len(served) - 1 != int(pos[j["slot"]]):
                return ({"gap_served": float("inf")},
                        {"gap_served": float("inf")} if mode else {})
            seq = np.concatenate([j["prompt"], served])[:P + n_served - 1]
            seq = torch.as_tensor(seq, device=dev)
            at = torch.arange(P - 1, P - 1 + n_served, device=dev)
            n = len(served)
            ref = rwkv6.forward(z, W, seq, prec.Prec(), at)
            gap = max(gap, compare.logit_gap(
                ref[:n], torch.as_tensor(served, device=dev)))
            if j["row"] is not None:
                pre_ref.append(ref[0])
                pre_got.append(seen.first["logits"][j["row"], :V])
            if j["last"]:
                dec_ref.append(ref[-1])
                dec_got.append(dec_logits[j["slot"], :V])
            if mode:
                lo = rwkv6.forward(z, W, seq, prec.Prec(mode), at)
                gap_lo = max(gap_lo, compare.logit_gap(ref[:n],
                                                       lo[:n].argmax(-1)))
                if j["row"] is not None:
                    pre_lo.append(lo[0])
                if j["last"]:
                    dec_lo.append(lo[-1])
    checks = {"gap_served": gap,
              "logits_prefill": compare.rel_err(torch.stack(pre_got),
                                                torch.stack(pre_ref)),
              "logits_decode": compare.rel_err(torch.stack(dec_got),
                                               torch.stack(dec_ref)),
              "served_tokens": float(sum(
                  len(j["tokens"]) for j in judged.values())),
              "requests": float(len(judged))}
    control = {}
    if mode:
        control = {"gap_served": gap_lo,
                   "logits_prefill": compare.rel_err(torch.stack(pre_lo),
                                                     torch.stack(pre_ref)),
                   "logits_decode": compare.rel_err(torch.stack(dec_lo),
                                                    torch.stack(dec_ref))}
    return checks, control
