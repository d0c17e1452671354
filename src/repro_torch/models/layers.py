"""Primitive layers: norms, rope, the MLP activation, the chunked loss.
Functions over tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def rms_norm(x, scale, eps=1e-6):
    """RMS norm scaled by (1 + scale), computed in f32."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(dt)


# ----------------------------------------------------------------------------
# RoPE (split-half convention)
# ----------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    # a Python-scalar base: torch.tensor(theta, device=cuda) would be a
    # blocking host-to-device copy on every layer
    return torch.pow(theta, exps)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [...] (a tensor); returns cos/sin [..., head_dim//2] f32."""
    ang = positions.float()[..., None] * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, hd]; cos/sin [S, hd//2] (broadcast over batch/heads)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dt)


# ----------------------------------------------------------------------------
# MLP activation
# ----------------------------------------------------------------------------
def gated_act(h, mlp_type: str):
    """h [..., G, ff] = x @ wi with the gate at [..., 0, :] and, for the
    gated types (G = 2), the up projection at [..., 1, :] -> [..., ff]."""
    if mlp_type == "swiglu":
        return F.silu(h[..., 0, :]) * h[..., 1, :]
    if mlp_type == "geglu":
        return F.gelu(h[..., 0, :], approximate="tanh") * h[..., 1, :]
    if mlp_type == "gelu":
        return F.gelu(h[..., 0, :], approximate="tanh")
    r = F.relu(h[..., 0, :])      # relu2
    return r * r


def mlp_act(h, mlp_type: str, d_ff: int):
    """The JAX package's activation over a fused wi: h [..., G ff] = x @ wi
    with [gate | up] side by side on the last dim for the gated types (the
    port's blocks keep G as its own dim and call gated_act instead)."""
    if mlp_type == "swiglu":
        g, u = h.chunk(2, dim=-1)
        return F.silu(g) * u
    if mlp_type == "geglu":
        g, u = h.chunk(2, dim=-1)
        return F.gelu(g, approximate="tanh") * u
    if mlp_type == "gelu":
        return F.gelu(h, approximate="tanh")
    if mlp_type == "relu2":
        r = F.relu(h)
        return r * r
    raise ValueError(mlp_type)


def mlp_fused_width(mlp_type: str, d_ff: int) -> int:
    """The fused wi's width: 2 d_ff for the gated types, else d_ff."""
    return (2 if mlp_type in ("swiglu", "geglu") else 1) * d_ff


def init_dense(gen: torch.Generator, shape, scale=0.02,
               dtype=torch.float32):
    """scale x N(0, 1) of `shape`, drawn in f32 from `gen` on its device,
    cast to `dtype`."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (scale * x).to(dtype)


# ----------------------------------------------------------------------------
# Loss: seq-chunked cross entropy against the vocab head
# ----------------------------------------------------------------------------
def chunked_cross_entropy(hidden, head, labels, *, chunk: int = 512,
                          logits_scale: float = 1.0,
                          valid_vocab: int | None = None):
    """Mean CE over tokens; logits never materialized beyond [B, chunk, V].

    hidden [B, S, d] - head [d, V] - labels [B, S]. Backward recomputes each
    chunk's logits (torch.utils.checkpoint), keeping the dominant temp at
    chunk granularity. The head product takes bf16-rounded operands and
    sums in f32, as the JAX package's bf16 dot with an f32 result does: the
    products of two bf16 values are exact in f32, so an f32 GEMM of the
    rounded operands is that function (a bf16 GEMM would round the logits;
    TF32 would round the operands further). Columns at or past valid_vocab
    (the padded vocab) are masked out.
    """
    B, S, d = hidden.shape
    n_chunks = S // chunk if S % chunk == 0 else -1
    if n_chunks == -1:  # fall back to single chunk
        n_chunks, chunk = 1, S

    def one(h, l):
        # the casts sit inside the chunk, as in the JAX package, so each
        # chunk's head gradient is rounded to bf16 before the chunks sum
        logits = (h.bfloat16().float() @ head.bfloat16().float()) \
            * logits_scale
        if valid_vocab is not None and valid_vocab < head.shape[-1]:
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(col < valid_vocab, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, l[..., None].long())[..., 0]
        return (lse - gold).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + torch.utils.checkpoint.checkpoint(
            one, hidden[:, sl], labels[:, sl], use_reentrant=False)
    return total / (B * S)
