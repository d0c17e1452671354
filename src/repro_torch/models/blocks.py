"""Per-layer block application: the dense (full-attention GQA), the
sliding-window (h2o-danube), the attention-free RWKV6, the SSD hybrid
(hymba: attention and SSD heads in parallel), the MoE (granite: the
dense attention, a routed expert FFN) and the mixed-kind (granite-4.0-h:
a Mamba-2 mixer or a NoPE GQA attention in each layer, then the routed
FFN plus a shared expert) families.

A layer is applied with one signature for prefill and decode; per-layer
behaviour (attention kind, cache group slot) rides in the LayerCtx.

Conventions:
  x [B, S, d]; p the per-layer leaves (no layer dim)
  kind: 0 = full attention, 1 = windowed, 2 = none (RWKV6: the time-mix
        takes its place; a mixed-kind model's Mamba-2 layer: its SSD
        mixer does)
  cache: dict of cache groups (see serve.cache); writes are in place

`kind` is a Python int, so each layer runs one path and writes only the
cache group it owns; the JAX package computes both under a `where` on a
traced kind, which writes the same values.

apply_layer_tp runs a layer over tensor-parallel shards (the spmd
backend's tp axis), in training, prefill and decode: the shards' attention
and MLP partials are summed on the stage's device where the JAX package
psums them over tp, each shard attending over its own cache shard.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, gated_act, layer_norm,
                                       rms_norm, rope_cos_sin)
from repro_torch.serve import cache as cache_lib


@dataclass
class LayerCtx:
    mode: str                       # train | prefill | decode
    pos: Any = None                 # decode positions: a [B] tensor
    q_offset: int = 0
    kind: int = 0                   # 0 full / 1 windowed
    full_i: int = 0                 # slot in the full-KV group
    win_i: int = 0                  # slot in the windowed group
    ssm_i: int = 0                  # slot in the ssm group
    lens: Optional[torch.Tensor] = None  # per-row prompt lengths ([B]) for
                                    # right-padded prefill; None = full rows
    kernel_backend: str = "ref"     # "ref" = plain torch paths; "cuda"
                                    # routes full-attention prefill/decode
                                    # the fresh-state RWKV6 and SSD
                                    # prefills and the MoE expert GEMMs
                                    # through the repro_torch kernels
                                    # (windowed layers run none)
    aux: Optional[list] = None      # training: each MoE layer appends its
                                    # load-balancing loss here (None: drop)
    merge: Optional[tuple] = None   # decode over sequence shards: the first
                                    # positions of the other data slots'
                                    # shards (their groups in
                                    # cache["kv_merge"]); every shard's
                                    # partial merges as JAX's pmax / psum
                                    # over data
    write_kv: bool = True           # False: the KV groups are another tp
                                    # shard's (KV whole over tp, trap Y3),
                                    # read here and written there


def _norm(cfg: ArchConfig, p, key, x):
    if cfg.norm_style == "ln_pre":
        return layer_norm(x, p[key], p[key + "_b"], eps=cfg.norm_eps)
    return rms_norm(x, p[key], eps=cfg.norm_eps)


def _mlp_dense(cfg: ArchConfig, p, x):
    """wi [d, G, ffl] (fused gate/up), wo [ffl, d]."""
    wi = p["mlp_wi"].to(x.dtype)
    h = (x @ wi.reshape(wi.shape[0], -1)).unflatten(-1, wi.shape[1:])
    return gated_act(h, cfg.mlp_type) @ p["mlp_wo"].to(x.dtype)


def _mlp_moe(cfg: ArchConfig, p, x, ctx: LayerCtx):
    """router [d, E], moe_w_in [E, d, G, ffl], moe_w_out [E, ffl, d]; the
    expert GEMMs run ctx.kernel_backend's path. The aux loss goes to
    ctx.aux when the caller collects it (training), else it is dropped."""
    moe_p = {"router": p["router"], "w_in": p["moe_w_in"],
             "w_out": p["moe_w_out"]}
    out, aux = moe_lib.moe_mlp(
        moe_p, x, num_experts=cfg.num_experts, top_k=cfg.top_k,
        mlp_type=cfg.mlp_type, capacity_factor=cfg.capacity_factor,
        backend=ctx.kernel_backend, expert_offset=cfg.expert_offset)
    if ctx.aux is not None:
        ctx.aux.append(aux)
    if cfg.shared_ff:
        out = out + _mlp_dense(cfg, {"mlp_wi": p["shared_wi"],
                                     "mlp_wo": p["shared_wo"]}, x)
    return out


# ----------------------------------------------------------------------------
# Attention mix
# ----------------------------------------------------------------------------
def _qkv(cfg: ArchConfig, p, xn, ctx: LayerCtx):
    B, S, _ = xn.shape
    hd = cfg.head_dim
    q = (xn @ p["wq"].to(xn.dtype)).reshape(B, S, -1, hd)
    k = (xn @ p["wk"].to(xn.dtype)).reshape(B, S, -1, hd)
    v = (xn @ p["wv"].to(xn.dtype)).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    if cfg.pos_emb == "nope":
        return q, k, v
    # rope (theta may differ for global layers, e.g. gemma3)
    tg = cfg.rope_theta_global or cfg.rope_theta
    theta = tg if ctx.kind == 0 else cfg.rope_theta
    if ctx.mode == "decode":
        positions = ctx.pos[:, None]                     # [B, 1]
    else:
        positions = ctx.q_offset + torch.arange(S, device=xn.device)
    cos, sin = rope_cos_sin(positions, hd, theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_train(cfg: ArchConfig, p, xn, ctx: LayerCtx, cache):
    """Train/prefill attention; prefill writes the layer's cache group in
    place (full layers: the pool or the contiguous group; windowed layers:
    the kv_win ring)."""
    q, k, v = _qkv(cfg, p, xn, ctx)
    B, S, Hl, hd = q.shape
    if ctx.kind == 1:
        o = attn_lib.banded_attention(q, k, v, window=cfg.window_size)
    elif ctx.kernel_backend != "ref":
        o = kernel_ops.attention(q, k, v, causal=True, window=0,
                                 backend=ctx.kernel_backend)
    else:
        o = attn_lib.flash_attention(q, k, v, causal=True, window=0)

    if ctx.mode == "prefill" and cache is not None and ctx.write_kv:
        if ctx.kind == 1:
            _ring_write_prompt(cache["kv_win"], ctx, k, v)
        else:
            _full_write_prompt(cache, ctx, k, v)
    return o.reshape(B, S, Hl * hd) @ p["wo"].to(xn.dtype), cache


def _full_write_prompt(cache, ctx: LayerCtx, k, v):
    """Write a prompt's K/V into the layer's kv_full group in place:
    through the block table (paged; positions at or past lens[b] keep the
    page's contents) or into the contiguous group (its last max_len
    positions, zeros past the prompt)."""
    kf, vf = cache["kv_full"]
    i = ctx.full_i
    B, S = k.shape[:2]
    if cache_lib.is_paged(cache):
        tab = cache["block_tab"]
        sel = torch.ones(B, dtype=torch.bool, device=k.device)
        cache_lib.page_write_prompt(kf, i, tab, k, sel, ctx.lens)
        cache_lib.page_write_prompt(vf, i, tab, v, sel, ctx.lens)
        return
    Sc = kf.shape[2]
    for grp, new in ((kf, k), (vf, v)):
        if S >= Sc:
            grp[i].copy_(new[:, -Sc:])
        else:
            grp[i, :, :S].copy_(new)
            grp[i, :, S:].zero_()


def _ring_write_prompt(kv_win, ctx: LayerCtx, k, v):
    """Write a prompt's K/V into the layer's ring group [m, B, W, KV, hd]
    in place: position t lands in slot t % W. With ctx.lens the prompt is
    walked in chunks of W (so each write's slots are unique) and a position
    at or past lens[b] keeps the slot's old value: every row's ring ends up
    holding exactly its own last min(W, lens[b]) tokens."""
    i = ctx.win_i
    W = kv_win[0].shape[2]
    S = k.shape[1]
    dev = k.device
    if ctx.lens is None:
        take = min(W, S)
        slots = (ctx.q_offset + S - take + torch.arange(take, device=dev)) % W
        for grp, new in zip(kv_win, (k, v)):
            grp[i][:, slots] = new[:, -take:].to(grp.dtype)
        return
    for c0 in range(0, S, W):
        take = min(W, S - c0)
        gpos = ctx.q_offset + c0 + torch.arange(take, device=dev)
        slots = gpos % W
        live = (gpos[None, :] < ctx.lens[:, None])[..., None, None]
        for grp, new in zip(kv_win, (k, v)):
            grp[i][:, slots] = torch.where(
                live, new[:, c0:c0 + take].to(grp.dtype), grp[i][:, slots])


def _attn_decode(cfg: ArchConfig, p, xn, ctx: LayerCtx, cache):
    """Single-token attention: ctx.pos is a [B] tensor (each row at its own
    depth). Full-attention K/V is read through the block table (paged
    trees) or directly (the contiguous layout); a windowed layer writes
    and reads its kv_win ring."""
    q, k, v = _qkv(cfg, p, xn, ctx)
    B, _, Hl, hd = q.shape
    pos_b = ctx.pos
    if ctx.kind == 1:
        # ring slot pos % W; slot j holds position pos - ((pos - j) % W)
        # (negative: not written yet); no kernel, as in the JAX package
        kw, vw = cache["kv_win"]
        i = ctx.win_i
        W = kw.shape[2]
        if ctx.write_kv:
            sel = torch.ones(B, dtype=torch.bool, device=xn.device)
            cache_lib.upd_kv_rows(kw, i, pos_b % W, k, sel)
            cache_lib.upd_kv_rows(vw, i, pos_b % W, v, sel)
        gpos = pos_b[:, None] - (
            (pos_b[:, None] - torch.arange(W, device=xn.device)) % W)
        o = attn_lib.decode_attend(q, kw[i], vw[i], gpos, pos_b,
                                   window=W + 1)
        return o.reshape(B, 1, Hl * hd) @ p["wo"].to(xn.dtype), cache
    kf, vf = cache["kv_full"]
    i = ctx.full_i

    if cache_lib.is_paged(cache):
        tab = cache["block_tab"]
        cap = tab.shape[1] * kf.shape[2]                 # pps * page_size
        if ctx.write_kv:
            sel = (pos_b >= 0) & (pos_b < cap)
            cache_lib.page_write_token(kf, i, tab, pos_b, k, sel)
            cache_lib.page_write_token(vf, i, tab, pos_b, v, sel)
        if ctx.kernel_backend != "ref":
            # the kernel indexes the pool through the block table with
            # per-row lengths: no page_view materialization
            lens_row = (pos_b + 1).clamp(0, cap).to(torch.int32)
            o = kernel_ops.decode_attention_paged(
                q[:, 0], kf, vf, tab, lens_row, layer=i,
                backend=ctx.kernel_backend)[:, None]
        else:
            k_view, gpos = cache_lib.page_view(kf, i, tab)
            v_view, _ = cache_lib.page_view(vf, i, tab)
            o = attn_lib.decode_attend(q, k_view, v_view, gpos, pos_b)
    else:
        # this slot's group (from position 0) and (ctx.merge) the other
        # data slots' sequence shards: the token lands in the shard holding
        # its position
        groups = (cache["kv_full"],) + cache.get("kv_merge", ())
        offs = (0,) + (ctx.merge or ())
        parts = []
        for (kf, vf), off in zip(groups, offs):
            Sc = kf.shape[2]
            li = pos_b - off
            if ctx.write_kv:
                in_rng = (li >= 0) & (li < Sc)
                lic = li.clamp(0, Sc - 1)
                cache_lib.upd_kv_rows(kf, i, lic, k, in_rng)
                cache_lib.upd_kv_rows(vf, i, lic, v, in_rng)
            if ctx.kernel_backend != "ref" and not ctx.merge:
                # per-row live lengths; the cache group goes in as a
                # strided [B, KV, S, hd] view, uncopied
                lens_row = (li + 1).clamp(0, Sc).to(torch.int32)
                o = kernel_ops.decode_attention(
                    q[:, 0], kf[i].transpose(1, 2), vf[i].transpose(1, 2),
                    lens_row, window=0, backend=ctx.kernel_backend)[:, None]
            else:
                # the merge runs no kernel, as in the JAX package
                gpos = off + torch.arange(Sc, device=xn.device)
                parts.append(attn_lib.decode_partial(q, kf[i], vf[i], gpos,
                                                     pos_b))
        if parts:
            o = attn_lib.merge_decode_partials(parts, q)
    return o.reshape(B, 1, Hl * hd) @ p["wo"].to(xn.dtype), cache


# ----------------------------------------------------------------------------
# SSM branches
# ----------------------------------------------------------------------------
def _ssd_branch(cfg: ArchConfig, p, xn, ctx: LayerCtx, cache):
    """The hybrid's SSD heads, or a Mamba-2 layer's mixer (p: the ssd_*
    leaves, prefix stripped). The cache's ssm_state [groups, B, H, N, P]
    and conv_tail [groups, B, 3, di + 2N] are written in place. The work
    is a span in the thread's bound scope: `ssd_prefill` (training and
    prefill: the projections, the chunked scan, the output) or
    `ssd_state_update` (a decode step's)."""
    H, N, di = cfg.n_ssm_heads, cfg.ssm_state, cfg.d_inner
    i = ctx.ssm_i
    kw = dict(heads=H, d_state=N, d_inner=di, gate_norm=cfg.ssm_gate_norm,
              eps=cfg.norm_eps)
    if ctx.mode == "decode":
        with obs.span("ssd_state_update"):
            y, st, tail = ssm_lib.ssd_mix_step(
                p, xn, cache["ssm_state"][i], cache["conv_tail"][i], **kw)
    else:
        with obs.span("ssd_prefill"):
            y, st, tail = ssm_lib.ssd_mix(
                p, xn, lens=ctx.lens if ctx.mode == "prefill" else None,
                kernel_backend=ctx.kernel_backend, **kw)
    if ctx.mode != "train" and cache is not None:
        cache["ssm_state"][i].copy_(st)
        cache["conv_tail"][i].copy_(tail)
    return y, cache


def _rwkv_layer(cfg: ArchConfig, p, x, ctx: LayerCtx, cache):
    """Full RWKV6 layer: ln1 + time-mix, ln2 + channel-mix. The cache's
    ssm_state [Lp, B, H, hd, hd] and shift [Lp, B, 2, d] (the time-mix and
    channel-mix token shifts) are written in place."""
    H = cfg.n_ssm_heads
    xx1 = rms_norm(x, p["ln1"], eps=cfg.norm_eps)
    lens = ctx.lens if ctx.mode == "prefill" else None
    i = ctx.ssm_i
    if ctx.mode == "decode":
        shifts = cache["shift"][i]                           # [B, 2, d]
        y, st2, last1 = ssm_lib.rwkv6_mix_step(
            p, xx1, cache["ssm_state"][i], shifts[:, 0:1], heads=H)
    else:
        y, st2, last1 = ssm_lib.rwkv6_mix(p, xx1, heads=H, lens=lens,
                                          kernel_backend=ctx.kernel_backend)
    x = x + y
    xx2 = rms_norm(x, p["ln2"], eps=cfg.norm_eps)
    xp = ssm_lib._shift(xx2, shifts[:, 1:2] if ctx.mode == "decode" else None)
    mk = xx2 + p["cm_mu_k"] * (xp - xx2)
    mr = xx2 + p["cm_mu_r"] * (xp - xx2)
    kk = F.relu(mk @ p["cm_k"].to(x.dtype))
    cm = (kk * kk) @ p["cm_v"].to(x.dtype)
    x = x + torch.sigmoid(mr @ p["cm_r"].to(x.dtype)) * cm
    if cache is not None:
        # channel-mix shift state: the last *real* token of each row
        last2 = ssm_lib._last_real(xx2, lens)
        cache["ssm_state"][i].copy_(st2)
        cache["shift"][i].copy_(torch.cat([last1, last2], dim=1))
    return x, cache


# ----------------------------------------------------------------------------
# Unified layer entry
# ----------------------------------------------------------------------------
def apply_layer(cfg: ArchConfig, p, x, ctx: LayerCtx, cache=None):
    """Returns (x_out, cache) for one dense, windowed, RWKV6, SSD-hybrid or
    MoE layer."""
    if cfg.ssm_type == "rwkv6":
        return _rwkv_layer(cfg, p, x, ctx, cache)
    xn = _norm(cfg, p, "ln1", x)
    if ctx.kind == 2:                       # a Mamba-2 layer's mixer
        att, cache = _ssd_branch(cfg, _ssd_leaves(p), xn, ctx, cache)
    elif ctx.mode == "decode":
        att, cache = _attn_decode(cfg, p, xn, ctx, cache)
    else:
        att, cache = _attn_train(cfg, p, xn, ctx, cache)
    return _finish_layer(cfg, p, x, xn, att, ctx, cache,
                         lambda xn2: _mlp(cfg, p, xn2, ctx))


def _ssd_leaves(p):
    return {k[4:]: v for k, v in p.items() if k.startswith("ssd_")}


def _mlp(cfg: ArchConfig, p, x, ctx: LayerCtx):
    return _mlp_moe(cfg, p, x, ctx) if cfg.num_experts else \
        _mlp_dense(cfg, p, x)


def _finish_layer(cfg: ArchConfig, p, x, xn, att, ctx: LayerCtx, cache,
                  mlp):
    """The layer after its attention output `att`: the hybrid's SSD branch,
    the sandwich norms, both residuals and the MLP (`mlp(xn2)`)."""
    if cfg.hybrid_parallel:
        sy, cache = _ssd_branch(cfg, _ssd_leaves(p), xn, ctx, cache)
        att = 0.5 * (rms_norm(att, p["bn_attn"], eps=cfg.norm_eps)
                     + rms_norm(sy, p["bn_ssm"], eps=cfg.norm_eps))
    if cfg.norm_style == "rms_sandwich":
        att = rms_norm(att, p["ln1_post"], eps=cfg.norm_eps)
    x = x + att
    m = mlp(_norm(cfg, p, "ln2", x))
    if cfg.norm_style == "rms_sandwich":
        m = rms_norm(m, p["ln2_post"], eps=cfg.norm_eps)
    return x + m, cache


def apply_layer_tp(cfg: ArchConfig, ps, x, ctx: LayerCtx, caches=None):
    """One layer over tp shards: ps[t] holds shard t's per-layer leaves
    (lm.shard_blocks), each on its slot's device; caches[t] (prefill and
    decode) shard t's cache (serve.cache.shard_cache's slot, sliced to the
    microbatch); x lives on the stage's device. As the JAX package's layer
    on each tp device: norm the (replicated) x once, take each shard's
    attention partial over its own cache shard and sum them (the psum,
    launch.mesh.psum; each shard's work in its slot's scope), add the
    residual; then the same for the dense or MoE MLP partials. Leaves
    the spec keeps whole (norms, router, the SSD branch, wk/wv when KV % tp
    != 0) are read from shard 0, and the SSD branch runs once, on shard 0's
    cache (its state is whole over tp).

    Every shard of a MoE layer routes the same tokens and computes the
    same load-balancing loss; the JAX package sums aux over stages only,
    so it counts once — here only shard 0 appends it to ctx.aux (trap Y2).
    Where KV % tp != 0 each shard holds all KV heads beside its H/tp query
    heads and groups them as the JAX device does (trap Y3); their cache is
    one copy, which shard 0 writes and the others read. One shard, and an
    RWKV6 layer (never tp-split), is apply_layer itself."""
    c0 = caches[0] if caches else None
    if len(ps) == 1 or cfg.ssm_type == "rwkv6":
        return apply_layer(cfg, ps[0], x, ctx, c0)[0]
    devs = [next(iter(p.values())).device for p in ps]
    xn = _norm(cfg, ps[0], "ln1", x)
    attn = _attn_decode if ctx.mode == "decode" else _attn_train
    reader = dataclasses.replace(
        ctx, write_kv=cfg.num_kv_heads % len(ps) == 0)
    parts = []
    for t, (p, d) in enumerate(zip(ps, devs)):
        with mesh_lib.slot(tp=t):
            parts.append(attn(cfg, p, xn.to(d), ctx if t == 0 else reader,
                              caches[t] if caches else None)[0])
    att = mesh_lib.psum(parts, x.device, axis="tp")
    quiet = dataclasses.replace(ctx, aux=None)

    def mlp(xn2):
        parts = []
        for t, (p, d) in enumerate(zip(ps, devs)):
            with mesh_lib.slot(tp=t):
                parts.append(_mlp(cfg, p, xn2.to(d),
                                  ctx if t == 0 else quiet))
        return mesh_lib.psum(parts, x.device, axis="tp")

    return _finish_layer(cfg, ps[0], x, xn, att, ctx, c0, mlp)[0]
