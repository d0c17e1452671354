"""The single-device wave step of a virtual worker (the port of
repro.core.wave's build_local_wave_step) and the pipeline tick schedule the
tracer renders (tick_schedule).

A wave is Nm microbatches computed with the wave-start weights: the grads
accumulate over them and the optimizer turns their mean into one delta.
The JAX package sums the microbatch losses inside one jax.grad; here each
microbatch runs backward on loss / Nm as it finishes, so at most one
microbatch's activations are alive at a time. The pipelined (spmd) wave
step is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import lm


def tick_schedule(stages: int, nm: int, *, overlap: bool = False
                  ) -> tuple[list, int]:
    """The pipeline schedule of a wave, as data: a list of (stage, tick, mb)
    entries — mb = -1 for bubble ticks — plus the tick count. Microbatch j
    reaches stage s at tick j + skew*s (skew 2 under the software-pipelined
    overlap schedule, else 1). Observability renders this as per-stage trace
    tracks; bubble fraction = 1 - nm*stages/len(entries)."""
    skew = 2 if overlap else 1
    ticks = nm + skew * (stages - 1)
    sched = []
    for s in range(stages):
        for t in range(ticks):
            mb = t - skew * s
            sched.append((s, t, mb if 0 <= mb < nm else -1))
    return sched, ticks


def wave_grads(cfg: ArchConfig, nm: int, params, inputs, labels):
    """(mean microbatch loss as a 0-d tensor, grads shaped like params) of
    one wave at `params`. inputs / labels [B, S] split into nm microbatches
    of B / nm rows; a leaf no microbatch reaches gets zeros."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    B = labels.shape[0]
    xw = inputs.reshape(nm, B // nm, *inputs.shape[1:])
    lw = labels.reshape(nm, B // nm, labels.shape[1])
    total = torch.zeros((), dtype=torch.float32, device=labels.device)
    for j in range(nm):
        loss, _ = lm.forward_ref(cfg, leaves, xw[j], mode="train",
                                 labels=lw[j])
        (loss / nm).backward()
        total = total + loss.detach()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    return total / nm, grads


def build_local_wave_step(cfg: ArchConfig, nm: int, optimizer):
    """wave_step(params, opt_state, inputs, labels) -> (deltas, opt_state,
    loss): one wave's grads at the wave-start `params` (a tree of tensors),
    turned into additive deltas by `optimizer`. inputs / labels are token
    ids (numpy or tensors), moved to the params' device."""

    def wave_step(params, opt_state, inputs, labels):
        dev = next(iter(params["blocks"].values())).device
        inputs = torch.as_tensor(inputs, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        loss, grads = wave_grads(cfg, nm, params, inputs, labels)
        with torch.no_grad():
            deltas, opt_state = optimizer.update(grads, opt_state, params)
        return deltas, opt_state, loss

    return wave_step
