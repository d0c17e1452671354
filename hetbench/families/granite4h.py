"""Family `granite4h`: granite-4.0-h's layers, each a Mamba-2 mixer or a
GQA attention without position embedding, then a routed SwiGLU expert FFN
under a static capacity (this card's share of the experts) plus a shared
SwiGLU expert; a tied head. The plain reference is reference/granite4h.py.
It serves only: no training loss.

A leaf of one layer kind is stacked over that kind's layers only, so the
weights come from `make` here and not from hetbench/weights.py (which
stacks every leaf over every layer); drivers/scheduler_hybrid.py calls
it. `sizes` gives the benchmark's per-layer kernel counts (costs.py,
multiplied by L in the readers) what they need for a model whose kernels
run in some of its layers only: H and KV are the attention heads averaged
over all L layers (the attention layers' heads times their share of the
layers), so L x a layer's count is the attention layers' total; E is the
experts held here and K the choices a token makes into them under an even
routing (top_k x E / E_route)."""
from __future__ import annotations

import math

import torch

from hetbench import costs
from hetbench.reference import compare, granite4h, prec

ATTN = ("wq", "wk", "wv", "wo")
CHUNK = 64           # ssd_chunked's chunk


def sizes(f: dict) -> dict:
    types = list(f["layer_types"])
    L, n_attn = len(types), types.count("attention")
    E_route, held = int(f["num_experts"]), int(f["experts_held"])
    Hs, di = int(f["ssm_heads"]), int(f["ssm_expand"]) * int(f["d_model"])
    return {"types": types, "n_attn": n_attn, "n_mamba": L - n_attn,
            "Ha": int(f["num_heads"]), "KVa": int(f["num_kv_heads"]),
            "H": int(f["num_heads"]) * n_attn / L,
            "KV": int(f["num_kv_heads"]) * n_attn / L,
            "hd": int(f["head_dim"]), "E": held, "E_route": E_route,
            "offset": int(f.get("expert_offset", 0)),
            "K_route": int(f["top_k"]),
            "K": int(f["top_k"]) * held / E_route,
            "cf": float(f["capacity_factor"]), "sff": int(f["shared_ff"]),
            "Hs": Hs, "N": int(f["ssm_state"]), "P": di // Hs, "di": di}


def _rows(z, name) -> int:
    kind = "attention" if name in ATTN else \
        "mamba" if name.startswith("ssd_") else None
    return z["L"] if kind is None else z["types"].count(kind)


def block_specs(z: dict) -> dict:
    """{leaf: (per-layer shape, init, scale)} of the leaves a layer may
    have (its kind's and the FFN's)."""
    d, ff, E, hd = z["d"], z["ff"], z["E"], z["hd"]
    di, N, Hs = z["di"], z["N"], z["Hs"]
    out_scale = 0.02 / math.sqrt(2 * z["L"])
    c = di + 2 * N
    return {"ln1": ((d,), "normal", 0.02), "ln2": ((d,), "normal", 0.02),
            "wq": ((d, z["Ha"] * hd), "normal", 0.02),
            "wk": ((d, z["KVa"] * hd), "normal", 0.02),
            "wv": ((d, z["KVa"] * hd), "normal", 0.02),
            "wo": ((z["Ha"] * hd, d), "normal", out_scale),
            "router": ((d, z["E_route"]), "normal", 0.02),
            "moe_w_in": ((E, d, 2, ff), "normal", 0.02),
            "moe_w_out": ((E, ff, d), "normal", out_scale),
            "shared_wi": ((d, 2, z["sff"]), "normal", 0.02),
            "shared_wo": ((z["sff"], d), "normal", out_scale),
            "ssd_in_proj": ((d, di + c + Hs), "normal", 0.02),
            "ssd_conv_w": ((4, c), "normal", 0.2),
            "ssd_conv_b": ((c,), "normal", 0.02),
            # dt = softplus(dt_raw + dt_bias) near 0.001..0.1, A = -exp(A_log)
            # in [-16, -1], as Mamba-2 initialises them
            "ssd_dt_bias": ((Hs,), "uniform", (-6.9, -2.25)),
            "ssd_A_log": ((Hs,), "uniform", (0.0, math.log(16.0))),
            "ssd_D": ((Hs,), "one_plus", 0.02),
            "ssd_norm_scale": ((di,), "normal", 0.02),
            "ssd_out_proj": ((di, d), "normal", out_scale)}


def leaf_specs(z: dict) -> dict:
    """{name: (shape, init, scale)} of every leaf of the port's tree."""
    specs = {f"blocks/{n}": ((_rows(z, n),) + s, i, c)
             for n, (s, i, c) in block_specs(z).items()}
    specs["final_norm"] = ((z["d"],), "normal", 0.02)
    specs["embed"] = ((z["Vp"], z["d"]), "normal", 0.02)
    return specs


def make(z: dict, seed: int, *, dtype, device) -> dict:
    """The port's parameter tree, drawn from `seed` on `device` in `dtype`
    as hetbench/weights.py draws it (leaves in sorted order, one
    generator call each), a kind's leaves over its own layers."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    params = {"blocks": {}}
    for name, (shape, init, c) in sorted(leaf_specs(z).items()):
        if init == "uniform":
            t = torch.rand(shape, generator=g, device=device, dtype=dtype)
            t.mul_(c[1] - c[0]).add_(c[0])
        else:
            t = torch.randn(shape, generator=g, device=device, dtype=dtype)
            t.mul_(c)
            if init == "one_plus":
                t.add_(1.0)
        if name.startswith("blocks/"):
            params["blocks"][name[7:]] = t
        else:
            params[name] = t
    return params


# ---------------------------------------------------------------------------
# FLOPs and the SSD kernel's cost
# ---------------------------------------------------------------------------
def matmul_params(z) -> float:
    """Weights one token multiplies through on this card: each layer's
    mixer (attention or Mamba-2), the router, the K choices it makes into
    the experts held here, the shared expert, the head (the embedding
    lookup excluded)."""
    d, hd, di, N, Hs = z["d"], z["hd"], z["di"], z["N"], z["Hs"]
    attn = 2 * d * (z["Ha"] + z["KVa"]) * hd
    mamba = d * (2 * di + 2 * N + Hs) + di * d
    ffn = d * z["E_route"] + z["K"] * 3 * d * z["ff"] + 3 * d * z["sff"]
    return float(z["n_attn"] * attn + z["n_mamba"] * mamba + z["L"] * ffn
                 + d * z["vocab"])


def _scan_flops(z) -> float:
    """A token's SSD recurrence in one Mamba layer, as a decode step runs
    it: the state's decay and injection and its read-out (6 N P a head)."""
    return 6.0 * z["Hs"] * z["N"] * z["P"]


def token_flops(z, pos: int) -> float:
    """Forward FLOPs of one decoded token at position pos (causal context
    pos + 1 in the attention layers)."""
    return 2.0 * matmul_params(z) + z["n_mamba"] * _scan_flops(z) \
        + z["n_attn"] * 4.0 * z["Ha"] * z["hd"] * (pos + 1)


def prompt_flops(z, L: int) -> float:
    """Forward FLOPs of a prompt of L real tokens (its SSD as
    ssd_chunked's work over them)."""
    return 2.0 * matmul_params(z) * L \
        + z["n_mamba"] * ssd_chunked(z, [L])[0] \
        + z["n_attn"] * 4.0 * z["Ha"] * z["hd"] * L * (L + 1) / 2


def ssd_chunked(z, lens, elt=4) -> tuple:
    """(FLOPs, bytes) of ssd_chunked's work in one Mamba layer over the
    real prompts of lengths `lens`, each from a zero state (float32): per
    chunk of n <= 64 positions C B^T once over the causal triangle (the N
    state columns shared by every head: 2 tri N), and per head the
    intra-chunk product over the triangle (2 tri P), the read-out of the
    carried state and the state's update (2 x 2 n N P); x, dt, B, C read
    once, y written once, each prompt's final state written once."""
    H, N, P = z["Hs"], z["N"], z["P"]
    flops = nbytes = 0.0
    for L in lens:
        for t0 in range(0, int(L), CHUNK):
            n = min(CHUNK, int(L) - t0)
            tri = n * (n + 1) // 2
            flops += 2 * tri * N + H * (2 * tri * P + 4 * n * N * P)
        nbytes += elt * (2 * H * L * P + H * L + 2 * L * N + H * N * P)
    return flops, nbytes


def ssd_bound_s(z, lens) -> float:
    """The least time the Mamba layers' ssd_chunked calls could take over
    these prompts on the H100 (f32 outside the tensor cores)."""
    return z["n_mamba"] * costs.bound_s(*ssd_chunked(z, lens), costs.PEAK_F32)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------
def check_serve(ctx, z, reqs, seen, mode):
    """Serving judged call by call (MoE capacity couples every row of a
    call, so the reference recomputes whole calls). The window's first
    admission group from scratch: its served first tokens' logit gap, its
    logits, two rows' K/V as the pages hold them and their Mamba state
    after the prefill. The window's first group (from the prompts and
    lengths the program's call took: its idle rows take expert capacity
    too): its real rows' logits and logit gap, and up to two real rows'
    Mamba state. Then one decode step of the whole batch from the
    program's own pages, states and conv tails as the window left them
    (drivers/scheduler_hybrid.py takes it after the window): its logits,
    the K/V it wrote and the state it left in eight live rows."""
    mix, dev = ctx.mix, ctx.device
    first = seen.first
    B, P = int(mix["max_batch"]), int(mix["prompt_len"])
    W = make(z, ctx.seed, dtype=torch.bfloat16, device=dev)
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
        ref, kv, st = granite4h.prefill(z, W, toks, lens, prec.Prec(), rows)
        checks["gap_prefill"] = compare.logit_gap(ref[:n0], served)
        checks["logits_prefill"] = compare.rel_err(
            first["logits"][:n0, :z["vocab"]], ref[:n0])
        checks["kv_prefill"] = _kv_prefill(first, kv, lens, rows)
        checks["state_prefill"] = compare.rel_err(
            torch.stack([first["state"][j] for j in rows], 1),
            torch.stack([st[l][0] for l in sorted(st)]))
        if mode:
            lo, kv_lo, st_lo = granite4h.prefill(z, W, toks, lens,
                                                 prec.Prec(mode), rows)
            control["gap_prefill"] = compare.logit_gap(
                ref[:n0], lo[:n0].argmax(-1))
            control["logits_prefill"] = compare.rel_err(lo[:n0], ref[:n0])
            control["kv_prefill"] = max(
                compare.rel_err(kv_lo[l][s], kv[l][s])
                for l in kv for s in (0, 1))
            control["state_prefill"] = compare.rel_err(
                torch.stack([st_lo[l][0] for l in sorted(st)]),
                torch.stack([st[l][0] for l in sorted(st)]))
            del lo, kv_lo, st_lo
        del ref, kv, st
        win = seen.window
        wt = torch.as_tensor(win["prompts"], device=dev).long()
        wl = torch.as_tensor(win["lens"], device=dev).long()
        n, rows = win["n"], sorted(win["state"])
        got = win["logits"][:n, :z["vocab"]]
        ref, _, st = granite4h.prefill(z, W, wt, wl, prec.Prec(), rows)
        want = torch.stack([st[l][0] for l in sorted(st)])
        checks["gap_window"] = compare.logit_gap(ref[:n], got.argmax(-1))
        checks["logits_window"] = compare.rel_err(got, ref[:n])
        checks["state_window"] = compare.rel_err(
            torch.stack([win["state"][j] for j in rows], 1), want)
        if mode:
            lo, _, st_lo = granite4h.prefill(z, W, wt, wl, prec.Prec(mode),
                                             rows)
            control["gap_window"] = compare.logit_gap(ref[:n],
                                                      lo[:n].argmax(-1))
            control["logits_window"] = compare.rel_err(lo[:n], ref[:n])
            control["state_window"] = compare.rel_err(
                torch.stack([st_lo[l][0] for l in sorted(st)]), want)
            del lo, st_lo
        del ref, st, want
        d = seen.decode
        live = d["tab"][:, 0] >= 0
        b = torch.nonzero(live).squeeze(1)
        sel = b[torch.linspace(0, len(b) - 1, min(8, len(b)),
                               device=dev).round().long()].tolist()
        kp, vp = seen.store.tree["kv_full"]
        ref, nk, nv, st = granite4h.decode(
            z, W, d["toks"], d["pos"], d["tab"], kp, vp, d["ssm_state"],
            d["conv_tail"], prec.Prec(), sel)
        logits = d["logits"][:, :z["vocab"]]
        checks["gap_decode"] = compare.logit_gap(ref[live],
                                                 logits[live].argmax(-1))
        checks["logits_decode"] = compare.rel_err(logits[live], ref[live])
        ps = kp.shape[2]
        pos = d["pos"]
        page, off = d["tab"][b, pos[b] // ps].long(), pos[b] % ps
        checks["kv_decode"] = max(
            compare.rel_err(kp[:, page, off], nk[:, b]),
            compare.rel_err(vp[:, page, off], nv[:, b]))
        want = torch.stack([st[l][0] for l in sorted(st)])
        checks["state_decode"] = compare.rel_err(
            seen.store.tree["ssm_state"][:, sel], want)
        if mode:
            lo, lk, lv, st_lo = granite4h.decode(
                z, W, d["toks"], d["pos"], d["tab"], kp, vp, d["ssm_state"],
                d["conv_tail"], prec.Prec(mode), sel)
            control["gap_decode"] = compare.logit_gap(ref[live],
                                                      lo[live].argmax(-1))
            control["logits_decode"] = compare.rel_err(lo[live], ref[live])
            control["kv_decode"] = max(compare.rel_err(lk[:, b], nk[:, b]),
                                       compare.rel_err(lv[:, b], nv[:, b]))
            control["state_decode"] = compare.rel_err(
                torch.stack([st_lo[l][0] for l in sorted(st)]), want)
    return checks, control


def _kv_prefill(first, kv, lens, rows) -> float:
    """The worst rms gap of two rows' prefill K/V as the pages hold them
    (each attention layer's group in turn) against the reference's."""
    errs = []
    for i, j in enumerate(rows):
        n = int(lens[j])
        for got, s in zip(first["snap"][j], (0, 1)):
            got = got.reshape(got.shape[0], -1, *got.shape[3:])[:, :n]
            want = torch.stack([kv[l][s][i, :n] for l in sorted(kv)])
            errs.append(compare.rel_err(got, want))
    return max(errs)
