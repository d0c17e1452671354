"""Per-layer block application: the dense (full-attention GQA) and the
attention-free RWKV6 families.

A layer is applied with one signature for prefill and decode; per-layer
behaviour (attention kind, cache group slot) rides in the LayerCtx.

Conventions:
  x [B, S, d]; p the per-layer leaves (no layer dim)
  kind: 0 = full attention, 2 = none (RWKV6: the time-mix takes its place)
  cache: dict of cache groups (see serve.cache); writes are in place

The windowed (h2o-danube, gemma3 local layers), MoE (granite) and SSD
hybrid (hymba) branches are ROADMAP Queue 1 item 5 and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, layer_norm, rms_norm,
                                       rope_cos_sin)
from repro_torch.serve import cache as cache_lib

_LATER = "ROADMAP Queue 1 item 5 (the other families)"


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
                                    # and the fresh-state RWKV6 prefill
                                    # through the repro_torch.kernels


def _norm(cfg: ArchConfig, p, key, x):
    if cfg.norm_style == "ln_pre":
        return layer_norm(x, p[key], p[key + "_b"], eps=cfg.norm_eps)
    return rms_norm(x, p[key], eps=cfg.norm_eps)


def _mlp_dense(cfg: ArchConfig, p, x):
    """wi [d, G, ffl] (fused gate/up), wo [ffl, d]."""
    wi = p["mlp_wi"].to(x.dtype)
    h = (x @ wi.reshape(wi.shape[0], -1)).unflatten(-1, wi.shape[1:])
    if cfg.mlp_type == "swiglu":
        a = F.silu(h[..., 0, :]) * h[..., 1, :]
    elif cfg.mlp_type == "geglu":
        a = F.gelu(h[..., 0, :], approximate="tanh") * h[..., 1, :]
    elif cfg.mlp_type == "gelu":
        a = F.gelu(h[..., 0, :], approximate="tanh")
    else:  # relu2
        r = F.relu(h[..., 0, :])
        a = r * r
    return a @ p["mlp_wo"].to(x.dtype)


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
    """Train/prefill attention; prefill writes the cache in place."""
    if ctx.kind != 0:
        raise NotImplementedError(f"windowed attention layers are {_LATER}")
    q, k, v = _qkv(cfg, p, xn, ctx)
    B, S, Hl, hd = q.shape
    if ctx.kernel_backend != "ref":
        o = kernel_ops.attention(q, k, v, causal=True, window=0,
                                 backend=ctx.kernel_backend)
    else:
        o = attn_lib.flash_attention(q, k, v, causal=True, window=0)

    if ctx.mode == "prefill" and cache is not None and "kv_full" in cache:
        kf, vf = cache["kv_full"]
        i = ctx.full_i
        if cache_lib.is_paged(cache):
            tab = cache["block_tab"]
            sel = torch.ones(B, dtype=torch.bool, device=xn.device)
            cache_lib.page_write_prompt(kf, i, tab, k, sel, ctx.lens)
            cache_lib.page_write_prompt(vf, i, tab, v, sel, ctx.lens)
        else:
            Sc = kf.shape[2]
            for grp, new in ((kf, k), (vf, v)):
                if S >= Sc:
                    grp[i].copy_(new[:, -Sc:])
                else:
                    grp[i, :, :S].copy_(new)
                    grp[i, :, S:].zero_()
    return o.reshape(B, S, Hl * hd) @ p["wo"].to(xn.dtype), cache


def _attn_decode(cfg: ArchConfig, p, xn, ctx: LayerCtx, cache):
    """Single-token attention: ctx.pos is a [B] tensor (each row at its own
    depth). Full-attention K/V is read through the block table (paged
    trees) or directly (the contiguous layout)."""
    if ctx.kind != 0 or "kv_win" in cache:
        raise NotImplementedError(f"windowed attention layers are {_LATER}")
    q, k, v = _qkv(cfg, p, xn, ctx)
    B, _, Hl, hd = q.shape
    pos_b = ctx.pos
    kf, vf = cache["kv_full"]
    i = ctx.full_i

    if cache_lib.is_paged(cache):
        tab = cache["block_tab"]
        cap = tab.shape[1] * kf.shape[2]                 # pps * page_size
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
        Sc = kf.shape[2]
        in_rng = (pos_b >= 0) & (pos_b < Sc)
        lic = pos_b.clamp(0, Sc - 1)
        cache_lib.upd_kv_rows(kf, i, lic, k, in_rng)
        cache_lib.upd_kv_rows(vf, i, lic, v, in_rng)
        if ctx.kernel_backend != "ref":
            # per-row live lengths; the cache group goes in as a strided
            # [B, KV, S, hd] view, uncopied
            lens_row = (pos_b + 1).clamp(0, Sc).to(torch.int32)
            o = kernel_ops.decode_attention(
                q[:, 0], kf[i].transpose(1, 2), vf[i].transpose(1, 2),
                lens_row, window=0, backend=ctx.kernel_backend)[:, None]
        else:
            gpos = torch.arange(Sc, device=xn.device)
            o = attn_lib.decode_attend(q, kf[i], vf[i], gpos, pos_b)
    return o.reshape(B, 1, Hl * hd) @ p["wo"].to(xn.dtype), cache


# ----------------------------------------------------------------------------
# RWKV6
# ----------------------------------------------------------------------------
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
    """Returns (x_out, cache) for one dense or RWKV6 layer."""
    if cfg.ssm_type == "rwkv6":
        return _rwkv_layer(cfg, p, x, ctx, cache)
    if cfg.hybrid_parallel:
        raise NotImplementedError(f"the SSD hybrid branch is {_LATER}")
    if cfg.num_experts:
        raise NotImplementedError(f"MoE layers are {_LATER}")
    xn = _norm(cfg, p, "ln1", x)
    if ctx.mode == "decode":
        att, cache = _attn_decode(cfg, p, xn, ctx, cache)
    else:
        att, cache = _attn_train(cfg, p, xn, ctx, cache)
    if cfg.norm_style == "rms_sandwich":
        att = rms_norm(att, p["ln1_post"], eps=cfg.norm_eps)
    x = x + att
    m = _mlp_dense(cfg, p, _norm(cfg, p, "ln2", x))
    if cfg.norm_style == "rms_sandwich":
        m = rms_norm(m, p["ln2_post"], eps=cfg.norm_eps)
    return x + m, cache
