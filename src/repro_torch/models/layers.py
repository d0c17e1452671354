"""Primitive layers: norms, rope, the MLP activation. Functions over
tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
