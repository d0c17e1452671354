"""The wave steps (the port of repro.core.wave): the pipelined spmd train
step over a (data, stage, tp) mesh, the single-device wave step of a
virtual worker, and the pipeline tick schedule the tracer renders.

A wave is Nm microbatches computed with the wave-start weights: the grads
accumulate over them and the optimizer turns their mean into one delta.

build_local_wave_step (the threads backend's worker, and the pipeline's
oracle): the JAX package sums the microbatch losses inside one jax.grad;
here each microbatch runs backward on loss / Nm as it finishes, so at
most one microbatch's activations are alive at a time.

build_train_step (backend "spmd", HetPipe's virtual worker as one
program): the stage x tp slots of a data slot hold the k GPUs of a VW;
microbatch j reaches stage s at tick j + skew*s and the stages hand their
boundary activations on tick by tick; the data slots are the VWs, reduced
once per wave (WSP at D = 0). The JAX package runs it as one shard_map
program per device; here one controller issues every slot's work onto the
slot's device (launch.mesh), in a Python loop over the ticks, and one
backward runs through the whole wave as JAX's value_and_grad does. The
collectives are tensor ops: the psum over tp sums the shards' partials
(blocks.apply_layer_tp), the ppermute over stage moves a stage's output to
the next stage's device, the masked psum from the last stage is taking the
last stage's output, and the mean over data slots is a Python mean (on one
device every data slot reads the same leaves, so autograd's accumulation
is the gradient all-reduce; across devices the .to() copies' backward is).

Bubble ticks and padded layer slots are skipped in Python; JAX computes
masked garbage there and discards it with a `where`, so the results are
the same. The serve steps (build_prefill_step, build_decode_step) are the
serve half of ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import lm
from repro_torch.models.blocks import LayerCtx
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.optim import make_optimizer

S_AX, T_AX, D_AX = "stage", "tp", "data"


def dp_axes(mesh):
    return tuple(a for a in ("pod", D_AX) if a in mesh.axis_names)


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


def n_dp(mesh) -> int:
    axes = dp_axes(mesh)
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


# ----------------------------------------------------------------------------
# one data slot's pipeline
# ----------------------------------------------------------------------------
def pipeline_wave(cfg: ArchConfig, shards, x_local, meta, *, mode: str,
                  nm: int, remat: bool = False, overlap: bool = False):
    """One VW's wave through its pipeline. shards: lm.shard_blocks's
    [stage][tp] per-layer leaves of this data slot; x_local [Bl, S, d] its
    rows, on stage 0's device; meta: lm.layer_meta's [stages, slots]
    arrays. Returns (y [Bl, S, d] on the last stage's device, aux: the
    stages' MoE losses summed over layers and microbatches).

    overlap=False is the baseline schedule: each tick computes and then
    hands its output to the next stage. overlap=True is the skewed one of
    the JAX package: each tick hands on the output computed *last* tick
    (the double-buffered carry), so microbatch j reaches stage s at tick j
    + 2s. Each microbatch meets the same compute in the same order, so the
    loss is bit-identical. With remat each stage call runs under
    torch.utils.checkpoint (jax.checkpoint in the JAX package): backward
    recomputes the stage from its saved input."""
    if mode != "train":
        raise NotImplementedError(
            f"pipeline_wave mode {mode!r}: prefill and decode are the serve "
            f"half of the spmd backend (ROADMAP Queue 1 item 9)")
    stages = cfg.stages
    Bl = x_local.shape[0]
    # one unbind: indexing a microbatch per tick would add a full-size zero
    # grad of x per microbatch in backward (trap L4)
    x_mbs = x_local.reshape(nm, Bl // nm, *x_local.shape[1:]).unbind(0)
    # a mesh tp above cfg.tp == 1 replicates: the layer runs whole, once
    tp_live = len(shards[0]) if cfg.tp > 1 else 1
    stage_dev = [next(iter(shards[s][0][0].values())).device
                 for s in range(stages)]
    skew = 2 if overlap else 1
    ticks = nm + skew * (stages - 1)

    def stage_fn(s):
        metas = {k: meta[k][s] for k in ("kind", "valid", "full_i",
                                         "win_i")}

        def call(x_in):
            aux = []
            y = lm.stage_apply(cfg, shards[s][:tp_live], x_in, metas,
                               LayerCtx(mode="train", aux=aux))
            return y, (torch.stack(aux).sum() if aux else
                       x_in.new_zeros((), dtype=torch.float32))

        if remat:
            return lambda x_in: torch.utils.checkpoint.checkpoint(
                call, x_in, use_reentrant=False, preserve_rng_state=False)
        return call

    fns = [stage_fn(s) for s in range(stages)]
    # buf: each stage's input, handed on last tick; sent (overlap): the
    # outputs computed last tick; out: the last stage's, per microbatch
    buf: list[Optional[torch.Tensor]] = [None] * stages
    sent: list[Optional[torch.Tensor]] = [None] * stages
    out: list[Optional[torch.Tensor]] = [None] * nm
    aux = []
    for t in range(ticks):
        ys: list[Optional[torch.Tensor]] = [None] * stages
        for s in range(stages):
            j = t - skew * s
            if not 0 <= j < nm:
                continue                                  # bubble tick
            y, a = fns[s](x_mbs[j] if s == 0 else buf[s])
            ys[s] = y
            aux.append(a)
            if s == stages - 1:
                out[j] = y
        # the ppermute s -> s + 1: of this tick's outputs, or (overlap) of
        # the previous tick's
        send, sent = (sent, ys) if overlap else (ys, sent)
        buf = [None] + [None if y is None else y.to(stage_dev[s + 1])
                        for s, y in enumerate(send[:-1])]
    aux_t = aux[0].to(stage_dev[-1])
    for a in aux[1:]:
        aux_t = aux_t + a.to(stage_dev[-1])
    return torch.cat(out), aux_t


def _meta_tree(cfg: ArchConfig):
    m = lm.layer_meta(cfg)
    return {k: m[k] for k in ("kind", "valid", "full_i", "win_i")}


def _cast_tree(tree, dtype):
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                    else a, tree)


def _loss_over_wave(cfg: ArchConfig, run: RunConfig, params, hid, labels):
    """hid [B, S, d] paired row for row with labels [B, S]. As the JAX
    package's spmd loss, the CE's logsumexp runs over the padded vocab
    (no valid_vocab mask, unlike lm_loss): trap Y5."""
    h = lm.final_hidden_norm(cfg, params, hid)
    return chunked_cross_entropy(h, lm.head_matrix(cfg, params), labels,
                                 chunk=min(run.loss_chunk, h.shape[-2]))


def _bcast_from_last(y, device):
    """The JAX package's masked psum over stages hands every stage the last
    stage's y for the vocab-sharded loss; here the loss runs whole on the
    params' device, so the last stage's y moves there."""
    return y.to(device)


# ----------------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------------
def build_train_step(run: RunConfig, mesh):
    """Returns (train_step, state_specs) where train_step(params,
    opt_state, batch{'inputs','labels'}) -> (params, opt_state, metrics
    {'loss', 'aux'}): the wave's grads by one backward through every data
    slot's pipeline, the optimizer's deltas, params + deltas (new
    tensors; the inputs are left as they were). params live on the mesh's
    first slot's device; the data slots take consecutive rows of the
    global batch."""
    cfg = run.arch
    assert cfg.stages == mesh.shape[S_AX], (cfg.stages, mesh.shape)
    assert cfg.tp in (1, mesh.shape[T_AX]), (cfg.tp, mesh.shape)
    nm = cfg.num_microbatches
    meta = _meta_tree(cfg)
    pspecs = lm.param_specs(cfg)
    cdt = torch.bfloat16 if run.compute_dtype == "bfloat16" else \
        torch.float32
    opt = make_optimizer(run.optimizer, run.lr, run.weight_decay)
    ndp = n_dp(mesh)
    grid = mesh.devices.reshape(ndp, mesh.shape[S_AX], mesh.shape[T_AX])

    def wave_loss(params, inputs, labels):
        x = lm.embed_tokens(cfg, params, inputs).to(cdt)
        blocks = _cast_tree(params["blocks"], cdt)
        Bl = x.shape[0] // ndp
        ys, auxs = [], []
        for d in range(ndp):
            y, aux = pipeline_wave(
                cfg, lm.shard_blocks(cfg, blocks, mesh, d),
                x[d * Bl:(d + 1) * Bl].to(grid[d, 0, 0]), meta,
                mode="train", nm=nm, remat=cfg.remat, overlap=run.overlap)
            ys.append(_bcast_from_last(y, x.device))
            auxs.append(aux.to(x.device))
        # JAX's psum over stages (done in pipeline_wave), pmean over the
        # data slots, then / nm: the mean microbatch aux (trap Y4)
        aux = auxs[0]
        for a in auxs[1:]:
            aux = aux + a
        aux = aux / ndp / nm
        loss = _loss_over_wave(cfg, run, params, torch.cat(ys), labels)
        return loss + 0.01 * aux / max(cfg.num_layers, 1), aux

    def train_step(params, opt_state, batch):
        dev = params["blocks"][next(iter(params["blocks"]))].device
        inputs = torch.as_tensor(batch["inputs"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        total, aux = wave_loss(leaves, inputs, labels)
        total.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), leaves)
        del leaves
        with torch.no_grad():
            deltas, opt_state = opt.update(grads, opt_state, params)
            del grads
            params = tree_map(torch.add, params, deltas)
        return params, opt_state, {"loss": total.detach(),
                                   "aux": aux.detach()}

    state_specs = {"params": pspecs,
                   "batch": {"inputs": (dp_axes(mesh),) + (None,) * (
                       1 if cfg.frontend == "none" else 2),
                             "labels": (dp_axes(mesh), None)},
                   "opt": None, "meta": meta, "optimizer": opt}
    return train_step, state_specs


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
