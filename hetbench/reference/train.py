"""The reference's first waves of training: per wave the mean over its
microbatches of the loss and of the gradient, then AdamW turned into an
additive delta, delta = -lr (m_hat / (sqrt(v_hat) + eps) + wd p) with the
bias corrections computed in float32, and the next wave's weights p +
delta (what the parameter server holds once the pushes have landed)."""
from __future__ import annotations

import numpy as np
import torch


def leaves(tree, prefix=""):
    """(name, tensor) of every leaf, names joined by '/', sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


FAULTS = ("half_batch", "no_exchange")


def waves(z, params, batches, nm: int, opt: dict, prec, loss_fn,
          fault=None, pull_every: int = 2):
    """Runs len(batches) waves from `params` (float32 leaves, not
    modified). batches: [(inputs [B, S], labels [B, S])] on the device;
    loss_fn(z, params, inputs, labels, prec) a microbatch's loss (the
    family's train_loss).
    Returns (losses, first gradient {leaf: norm}, params after the waves
    as {leaf: tensor}).

    `fault` plants one of a worker's faults in the reference, to read what
    it does to the numbers compared: "half_batch" takes the first half of
    each wave's microbatches and their mean; "no_exchange" lets no push
    land, so every pull (after each pull_every-th wave) hands back the
    starting weights."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    p = {n: t.detach().clone() for n, t in leaves(params)}
    start = {n: t.clone() for n, t in p.items()} \
        if fault == "no_exchange" else None
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    losses, g1 = [], None
    for t, (x, y) in enumerate(batches, start=1):
        for q in p.values():
            q.requires_grad_(True)
            q.grad = None
        tree = unflatten(p)
        B = x.shape[0]
        total = 0.0
        used = nm // 2 if fault == "half_batch" else nm
        for j in range(used):
            rows = slice(j * B // nm, (j + 1) * B // nm)
            loss = loss_fn(z, tree, x[rows], y[rows], prec)
            (loss / used).backward()
            total += float(loss.detach())
        losses.append(total / used)
        with torch.no_grad():
            if g1 is None:
                g1 = {n: float(q.grad.norm()) for n, q in p.items()}
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
            for n, q in p.items():
                g = q.grad
                m[n] = b1 * m[n] + (1 - b1) * g
                v[n] = b2 * v[n] + (1 - b2) * g * g
                upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
                p[n] = (q.detach() + -lr * (upd + wd * q.detach()))
            if start is not None and t % pull_every == 0:
                p = {n: q.clone() for n, q in start.items()}
        del tree
    return losses, g1, {n: q.detach() for n, q in p.items()}


def unflatten(flat: dict) -> dict:
    tree = {}
    for name, t in flat.items():
        *path, last = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return tree
