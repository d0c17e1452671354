"""Layers both reference models use."""
from __future__ import annotations

import torch


def rms(x, w, eps):
    """RMS norm in float32, scaled by (1 + w)."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x, pos, theta: float):
    """Split-half rotary embedding. x [..., S, H, hd] float32; pos [S] or
    [B, S] integer positions."""
    hd = x.shape[-1]
    inv = torch.pow(theta, -torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[..., None] * inv
    c, s = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def layers(params) -> list:
    """Per-layer dicts of the stacked block leaves (one unbind a leaf, so a
    backward writes each leaf's gradient once), as float32."""
    names = sorted(params["blocks"])
    per = [params["blocks"][n].unbind(0) for n in names]
    return [{n: p[l].float() for n, p in zip(names, per)}
            for l in range(len(per[0]))]
