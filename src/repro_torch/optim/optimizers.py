"""Delta-producing optimizers (the port of repro.optim.optimizers).

WSP's parameter servers apply *additive deltas* (w_global += u). Local
optimizers therefore transform wave gradients into deltas; adaptive state
(momentum / Adam moments) stays virtual-worker-local, as parameter-server
deployments run adaptive optimizers. They are functions over trees of
tensors (`core.tree`) that return the update instead of applying it, which
is why torch.optim cannot stand in.

`step` counts updates in the state as a Python int; a learning rate may be
a float or a schedule `lr(step) -> float` (warmup_cosine).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.tree import tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable            # params -> state
    update: Callable          # (grads, state, params) -> (deltas, state)
    name: str = ""


def _tree_zeros(params):
    return tree_map(torch.zeros_like, params)


def _lr_at(lr, step: int) -> float:
    return float(lr(step)) if callable(lr) else lr


def sgd(lr):
    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        lr_t = _lr_at(lr, state["step"])
        deltas = tree_map(lambda g: -lr_t * g, grads)
        return deltas, {"step": state["step"] + 1}

    return Optimizer(init, update, "sgd")


def momentum(lr, mu=0.9):
    def init(params):
        return {"m": _tree_zeros(params), "step": 0}

    def update(grads, state, params):
        lr_t = _lr_at(lr, state["step"])
        m = tree_map(lambda m_, g: mu * m_ + g, state["m"], grads)
        deltas = tree_map(lambda m_: -lr_t * m_, m)
        return deltas, {"m": m, "step": state["step"] + 1}

    return Optimizer(init, update, "momentum")


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """Adam with decoupled weight decay inside the learning rate:
    delta = -lr (m̂ / (sqrt(v̂) + eps) + wd p). The bias corrections are
    computed in f32, as the JAX package computes them."""
    def init(params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params),
                "step": 0}

    def update(grads, state, params):
        t = state["step"] + 1
        lr_t = _lr_at(lr, state["step"])
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                     state["v"], grads)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))

        def delta(m_, v_, p):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            return -lr_t * (upd + weight_decay * p)

        deltas = tree_map(delta, m, v, params)
        return deltas, {"m": m, "v": v, "step": t}

    return Optimizer(init, update, "adamw")


def make_optimizer(name: str, lr, weight_decay: float = 0.1) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    raise ValueError(name)


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """step -> lr: linear warmup to peak_lr over `warmup` steps, then a
    cosine decay to floor * peak_lr at `total`."""
    def lr(step):
        step = float(step)
        if step < warmup:
            return peak_lr * min(1.0, (step + 1) / max(warmup, 1))
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5
                          * (1 + math.cos(math.pi * frac)))
    return lr
