"""Mixture-of-Experts: top-k routing with static capacity dispatch (the port
of repro.models.moe, without its expert-parallel all_to_all).

Every position of x [B, S, d] is routed, padding included: prefill runs at
[max_batch, prompt_len] with short prompts and dead rows padded with token
0, and those positions take expert capacity like real ones, so a real
token's output depends on the padding and on the other rows of its batch
(as in the JAX package). Choices past an expert's capacity are dropped in
token-major (token, choice) order and contribute nothing.

Weight layout: w_in [E, d, G, ff] (G = 2 for gated MLPs: gate; up), w_out
[E, ff, d]. The expert GEMMs run as the JAX package's einsums in the
compute dtype (backend "ref") or through kernels/ops.gmm, the Hopper
grouped matmul (backend "cuda"), on the contiguous [E, d, G ff] view of
w_in: no weight is copied per call.

`record_routing()` collects each call's router logits, choices and drops
(for the smoke's routing prints and the tests' margin checks); it is off
unless a caller opens it.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import gated_act

_RECORD: list | None = None


@contextlib.contextmanager
def record_routing():
    """Yields a list that gets one dict per moe_mlp call made inside the
    block, in call order: `logits` [T, E] f32, `idx` [T, K], `keep` [T, K]
    bool, `cap`, `shape` (B, S). The tensors stay where they were computed."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def topk_margin(logits, top_k: int):
    """[T, E] router logits -> [T]: the K-th largest minus the (K+1)-th, the
    distance at which a perturbation swaps a chosen expert for another."""
    top = torch.topk(logits.float(), top_k + 1, dim=-1).values
    return top[:, top_k - 1] - top[:, top_k]


def route_topk(logits, top_k: int):
    """logits [T, E] -> (weights [T, K], idx [T, K], aux_loss scalar)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    E = logits.shape[-1]
    me = probs.mean(dim=0)
    fe = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    return w, idx, E * (me * fe).sum()


def _expert_ffn(h_in, w_in, w_out, mlp_type: str, backend: str = "ref"):
    """h_in [E, C, d] -> [E, C, d] in h_in's dtype."""
    dt = h_in.dtype
    if kernel_ops.check_backend(backend) == "ref":
        h = torch.einsum("ecd,edgf->ecgf", h_in, w_in.to(dt))
        return torch.einsum("ecf,efd->ecd", gated_act(h, mlp_type),
                            w_out.to(dt))
    E, d, G, ff = w_in.shape
    h = kernel_ops.gmm(h_in, w_in.to(dt).reshape(E, d, G * ff),
                       backend=backend)
    a = gated_act(h.view(E, -1, G, ff), mlp_type)
    return kernel_ops.gmm(a, w_out.to(dt), backend=backend)


def capacity(T: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Rows per expert: max(4, ceil4(max(K, round(T K / E cf)))), with
    Python's round (half to even: round(2.5) == 2), as the JAX package."""
    cap = int(max(top_k, round(T * top_k / num_experts * capacity_factor)))
    return max(4, (cap + 3) // 4 * 4)


def moe_mlp(p, x, *, num_experts: int, top_k: int, mlp_type: str,
            capacity_factor: float = 1.25, backend: str = "ref"):
    """x [B, S, d] -> ([B, S, d], aux loss). p: router [d, E], w_in
    [E, d, G, ff], w_out [E, ff, d]."""
    B, S, d = x.shape
    T, E, K = B * S, num_experts, top_k
    xf = x.reshape(T, d)
    logits = xf.float() @ p["router"].float()
    w, idx, aux = route_topk(logits, K)
    cap = capacity(T, E, K, capacity_factor)

    # position of each (token, choice) in its expert's queue, token-major:
    # the JAX package's running count (a cumsum over a [T*K, E] one-hot),
    # here as each choice's rank among its expert's choices in a stable
    # sort (no host sync: bincount would read the max back)
    flat_e = idx.reshape(-1)                                  # [T*K]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    slot = torch.empty_like(flat_e)
    slot[order] = torch.arange(flat_e.numel(), device=x.device) - \
        first[sorted_e]
    keep = slot < cap
    dest = torch.where(keep, flat_e * cap + slot, E * cap)    # drop bucket
    if _RECORD is not None:
        _RECORD.append(dict(logits=logits, idx=idx, keep=keep.view(T, K),
                            cap=cap, shape=(B, S)))

    # kept choices land on distinct rows; only the drop bucket (row E*cap,
    # discarded) may be written twice
    buf = xf.new_zeros((E * cap + 1, d))
    buf.index_copy_(0, dest, xf.repeat_interleave(K, dim=0))
    out = _expert_ffn(buf[:-1].view(E, cap, d), p["w_in"], p["w_out"],
                      mlp_type, backend)

    flat_out = torch.cat([out.reshape(E * cap, d), out.new_zeros((1, d))])
    gathered = flat_out[dest].view(T, K, d)
    combined = torch.einsum("tkd,tk->td", gathered.float(),
                            w * keep.view(T, K))
    return combined.view(B, S, d).to(x.dtype), aux
