"""Mixture-of-Experts: top-k routing with static capacity dispatch (the port
of repro.models.moe; its expert-parallel all_to_all is moe_mlp_ep).

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

An expert share (a card of an expert-parallel deployment run without its
exchange): the router routes over all num_experts and capacity counts
them all, but w_in / w_out hold only experts [expert_offset, expert_offset
+ E_held); choices of the other experts are dropped as over-capacity
ones are, so the output is the held experts' part of the layer's.

`record_routing()` collects each call's router logits, choices and drops
(for the smoke's routing prints and the tests' margin checks); it is off
unless a caller opens it.
"""
from __future__ import annotations

import contextlib

import torch

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
    # the one-hot of the choices by a scatter into zeros: F.one_hot checks
    # the index range on the host (a sync) on the CPU, and issues other
    # ops on each device type; this issues the same ops everywhere
    hot = probs.new_zeros((*idx.shape, E)).scatter_(-1, idx[..., None], 1.0)
    fe = hot.sum(dim=1).mean(dim=0)
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


def _dispatch(p, x, *, num_experts: int, top_k: int,
              capacity_factor: float, held=None):
    """Route x [B, S, d]'s tokens and lay them out by expert: (expert_in
    [E, cap, d], dest [T K], w [T, K], keep [T K], aux, cap). held
    (offset, n): only experts [offset, offset + n) get rows (E = n); the
    rest's choices are dropped. None: every expert."""
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
    if held is not None:
        lo, E = held
        flat_e = flat_e - lo
        keep &= (flat_e >= 0) & (flat_e < E)
    dest = torch.where(keep, flat_e * cap + slot, E * cap)    # drop bucket
    if _RECORD is not None:
        _RECORD.append(dict(logits=logits, idx=idx, keep=keep.view(T, K),
                            cap=cap, shape=(B, S)))

    # kept choices land on distinct rows; only the drop bucket (row E*cap,
    # discarded) may be written twice
    buf = xf.new_zeros((E * cap + 1, d))
    buf.index_copy_(0, dest, xf.repeat_interleave(K, dim=0))
    return buf[:-1].view(E, cap, d), dest, w, keep, aux, cap


def _combine(out, x, dest, w, keep, top_k: int):
    """Each token's kept expert outputs [E, cap, d], weighted and summed,
    in x's shape and dtype."""
    B, S, d = x.shape
    T, K = B * S, top_k
    E, cap = out.shape[:2]
    flat_out = torch.cat([out.reshape(E * cap, d), out.new_zeros((1, d))])
    gathered = flat_out[dest].view(T, K, d)
    combined = torch.einsum("tkd,tk->td", gathered.float(),
                            w * keep.view(T, K))
    return combined.view(B, S, d).to(x.dtype)


def moe_mlp(p, x, *, num_experts: int, top_k: int, mlp_type: str,
            capacity_factor: float = 1.25, backend: str = "ref",
            expert_offset: int = 0):
    """x [B, S, d] -> ([B, S, d], aux loss). p: router [d, E], w_in
    [E_held, d, G, ff], w_out [E_held, ff, d]: experts expert_offset ..
    expert_offset + E_held of the E routed over (all by default)."""
    n = p["w_in"].shape[0]
    expert_in, dest, w, keep, aux, _ = _dispatch(
        p, x, num_experts=num_experts, top_k=top_k,
        capacity_factor=capacity_factor,
        held=None if n == num_experts else (expert_offset, n))
    out = _expert_ffn(expert_in, p["w_in"], p["w_out"], mlp_type, backend)
    return _combine(out, x, dest, w, keep, top_k), aux


def moe_mlp_ep(ps, xs, *, num_experts: int, top_k: int, mlp_type: str,
               capacity_factor: float = 1.25, mesh_axis: str = "data",
               backend=None):
    """The expert-parallel exchange over n shards (the JAX package's
    moe_mlp(..., ep_axis=) under shard_map, as a function over lists: one
    controller holds every shard). ps[i]: shard i's whole router [d, E] and
    its E/n experts' w_in [E/n, d, G, ff] / w_out [E/n, ff, d]; xs[i]:
    shard i's tokens [B, S, d] on its slot's device. Returns (per-shard
    outputs [B, S, d], per-shard aux losses), JAX's per-device values.

    Each shard routes its own tokens with a capacity from its own T; the
    all_to_all (launch.mesh.all_to_all over `mesh_axis`) sends expert
    group j to shard j, rows ordered by the shard they came from ([E/n,
    n cap, d]); each shard runs its experts' FFN (kernels.ops.gmm on
    backend "cuda"); the all_to_all sends the outputs back and each shard
    combines its own tokens. No Plan or Engine path calls it, as in the
    JAX package.

    Both legs keep rows by source shard, then slot: the order JAX's
    return leg reshapes by. JAX's forward leg (jax.lax.all_to_all with
    tiled=False puts the source axis at concat_axis) lays them out slot-
    major instead, so its tokens read other tokens' outputs once n > 1;
    here shard i's output is moe_mlp on its tokens with every expert
    (tests/test_torch_moe_ep.py)."""
    from repro_torch.launch import mesh as mesh_lib
    n, E = len(xs), num_experts
    if len(ps) != n or E % n:
        raise ValueError(f"moe_mlp_ep: {len(ps)} param shards, {n} token "
                         f"shards, {E} experts (must split evenly)")
    devs = [x.device for x in xs]
    sent = [_dispatch(p, x, num_experts=E, top_k=top_k,
                      capacity_factor=capacity_factor)
            for p, x in zip(ps, xs)]
    caps = {c for *_, c in sent}
    if len(caps) != 1:
        raise ValueError(f"moe_mlp_ep: shards with unequal capacities "
                         f"{sorted(caps)} (their token counts differ)")
    cap = caps.pop()
    d = xs[0].shape[-1]
    got = mesh_lib.all_to_all(
        [s[0].reshape(n, E // n, cap, d) for s in sent], devs,
        axis=mesh_axis, split_axis=0, concat_axis=2)
    outs = [_expert_ffn(g.reshape(E // n, n * cap, d), p["w_in"],
                        p["w_out"], mlp_type, kernel_ops.check_backend(
                            backend))
            for g, p in zip(got, ps)]
    back = mesh_lib.all_to_all(
        [o.reshape(E // n, n, cap, d).transpose(0, 1) for o in outs], devs,
        axis=mesh_axis, split_axis=0, concat_axis=0)
    ys = [_combine(b.reshape(E, cap, d), x, dest, w, keep, top_k)
          for b, x, (_, dest, w, keep, _, _) in zip(back, xs, sent)]
    return ys, [s[4] for s in sent]
