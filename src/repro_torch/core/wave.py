"""The wave steps (the port of repro.core.wave): the pipelined spmd train
step over a (data, stage, tp) mesh, the single-device wave step of a
virtual worker, and the pipeline tick schedule.

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
collectives are launch.mesh's named tensor ops: the psum over tp sums the
shards' partials (blocks.apply_layer_tp), the ppermute over stage moves a
stage's output to the next stage's device, the masked psum from the last
stage is taking the last stage's output, and the aux pmean over data
slots is a sum over them (on one device every data slot reads the same
leaves, so autograd's accumulation is the gradient all-reduce, which
therefore is no call: the dry run reckons it from the grads' bytes;
across devices the .to() copies' backward is). Each data slot's, stage's
and tp shard's work runs in its launch.mesh.slot scope, which a cost
counter reads (and which costs nothing without one).

Bubble ticks and padded layer slots are skipped in Python; JAX computes
masked garbage there and discards it with a `where`, so the results are
the same. The serve steps (build_prefill_step, build_decode_step) run
the same tick loop with the cache riding along: each (stage, tp) slot owns
its cache (serve.cache.shard_cache), and a live tick computes on the
microbatch's rows of it in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.tree import tree_map
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.models.blocks import LayerCtx
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.optim import make_optimizer
from repro_torch.serve import cache as cache_lib

S_AX, T_AX, D_AX = "stage", "tp", "data"


def dp_axes(mesh):
    return tuple(a for a in ("pod", D_AX) if a in mesh.axis_names)


def tick_schedule(stages: int, nm: int, *, overlap: bool = False
                  ) -> tuple[list, int]:
    """The pipeline schedule of a wave, as data: a list of (stage, tick, mb)
    entries — mb = -1 for bubble ticks — plus the tick count. Microbatch j
    reaches stage s at tick j + skew*s (skew 2 under the software-pipelined
    overlap schedule, else 1). The schedule's bubble share is
    1 - nm*stages/len(entries)."""
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
                  nm: int, cache=None, pos=None, lens=None, merge=None,
                  remat: bool = False, overlap: bool = False,
                  kernel_backend: str = "ref"):
    """One VW's wave through its pipeline. shards: lm.shard_blocks's
    [stage][tp] per-layer leaves of this data slot; x_local [Bl, S, d] its
    rows, on stage 0's device; meta: lm.layer_meta's [stages, slots]
    arrays. Returns (y [Bl, S, d] on the last stage's device, aux: the
    stages' MoE losses summed over layers and microbatches; None in
    prefill and decode, where the JAX package drops it too).

    overlap=False is the baseline schedule: each tick computes and then
    hands its output to the next stage. overlap=True is the skewed one of
    the JAX package: each tick hands on the output computed *last* tick
    (the double-buffered carry), so microbatch j reaches stage s at tick j
    + 2s. Each microbatch meets the same compute in the same order, so the
    loss (and in serve, the logits) is bit-identical. With remat each
    train stage call runs under torch.utils.checkpoint (jax.checkpoint in
    the JAX package): backward recomputes the stage from its saved input.

    Prefill and decode (no autograd): cache[s][t] is the (stage, tp)
    slot's cache (serve.cache.shard_cache): a live tick computes on
    slice_mb's views of the microbatch's rows, and every stage write lands
    in place through them (a layer that replaced a leaf would lose its
    write: the JAX package's update_mb step has nothing to do here); a
    bubble tick skips the slice and the stage call alike (as the JAX
    package's cond does). pos
    (decode, [Bl]) and lens (prefill, [Bl] or None) are sliced with the
    microbatch. merge (decode over a sequence-sharded cache): the other
    data slots' shard offsets, their kv_full groups in each slot's
    "kv_merge" (see build_decode_step)."""
    stages = cfg.stages
    Bl = x_local.shape[0]
    mb = Bl // nm
    # one unbind: indexing a microbatch per tick would add a full-size zero
    # grad of x per microbatch in backward (trap L4)
    x_mbs = x_local.reshape(nm, mb, *x_local.shape[1:]).unbind(0)
    # a mesh tp above cfg.tp == 1 replicates: the layer runs whole, once
    tp_live = len(shards[0]) if cfg.tp > 1 else 1
    stage_dev = [next(iter(shards[s][0][0].values())).device
                 for s in range(stages)]
    skew = 2 if overlap else 1
    ticks = nm + skew * (stages - 1)

    def stage_fn(s):
        metas = {k: meta[k][s] for k in ("kind", "valid", "full_i",
                                         "win_i")}

        def call(x_in, j):
            aux = []
            y = lm.stage_apply(cfg, shards[s][:tp_live], x_in, metas,
                               LayerCtx(mode="train", aux=aux))
            return y, (torch.stack(aux).sum() if aux else
                       x_in.new_zeros((), dtype=torch.float32))

        def serve_call(x_in, j):
            rows = slice(j * mb, (j + 1) * mb)
            dev = stage_dev[s]
            ctx = LayerCtx(
                mode=mode, kernel_backend=kernel_backend, merge=merge,
                pos=None if pos is None else pos[rows].to(dev),
                lens=None if lens is None else lens[rows].to(dev))
            views = [cache_lib.slice_mb(c, j, mb) for c in cache[s][:tp_live]]
            return lm.stage_apply(cfg, shards[s][:tp_live], x_in, metas, ctx,
                                  views), None

        if mode != "train":
            return serve_call
        if remat:
            return lambda x_in, j: torch.utils.checkpoint.checkpoint(
                call, x_in, j, use_reentrant=False, preserve_rng_state=False)
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
            with mesh_lib.slot(stage=s):
                y, a = fns[s](x_mbs[j] if s == 0 else buf[s], j)
            ys[s] = y
            if a is not None:
                aux.append(a)
            if s == stages - 1:
                out[j] = y
        # the ppermute s -> s + 1: of this tick's outputs, or (overlap) of
        # the previous tick's
        send, sent = (sent, ys) if overlap else (ys, sent)
        buf = [None]
        for s, y in enumerate(send[:-1]):
            if y is None:
                buf.append(None)
                continue
            with mesh_lib.slot(stage=s):
                buf.append(mesh_lib.ppermute(y, stage_dev[s + 1],
                                             axis=S_AX, n=stages))
    if not aux:
        return torch.cat(out), None
    # the psum of the stages' aux over stage (one partial a stage call)
    return torch.cat(out), mesh_lib.psum(aux, stage_dev[-1], axis=S_AX,
                                         n=stages)


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


def _bcast_from_last(y, device, stages: int):
    """The JAX package's masked psum over stages hands every stage the last
    stage's y for the vocab-sharded loss; here the loss runs whole on the
    params' device, so the last stage's y moves there: a psum of the one
    nonzero partial."""
    with mesh_lib.slot(stage=stages - 1):
        return mesh_lib.psum([y], device, axis=S_AX, n=stages)


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
        issued = mesh_lib.issued_data_slots(ndp)
        for d in range(ndp):
            if d >= issued:               # the dry run reckons it
                ys.append(mesh_lib.stand_in(ys[0]))
                auxs.append(mesh_lib.stand_in(auxs[0]))
                continue
            with mesh_lib.slot(data=d):
                y, aux = pipeline_wave(
                    cfg, lm.shard_blocks(cfg, blocks, mesh, d),
                    x[d * Bl:(d + 1) * Bl].to(grid[d, 0, 0]), meta,
                    mode="train", nm=nm, remat=cfg.remat,
                    overlap=run.overlap)
                ys.append(_bcast_from_last(y, x.device, cfg.stages))
                auxs.append(aux.to(x.device))
        # JAX's psum over stages (done in pipeline_wave), pmean over the
        # data slots, then / nm: the mean microbatch aux (trap Y4)
        aux = mesh_lib.pmean(auxs, x.device, axis=D_AX) / nm
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


# ----------------------------------------------------------------------------
# serve steps (prefill / decode)
# ----------------------------------------------------------------------------
def _serve_nm(run: RunConfig, mesh) -> tuple[int, int]:
    """(Nm, rows a microbatch) of a serve step: the arch's Nm, cut to the
    rows of a data slot and then to a divisor of them."""
    cfg, shp = run.arch, run.shape
    vw_b = max(1, shp.global_batch // n_dp(mesh))
    nm = min(cfg.num_microbatches, vw_b)
    while vw_b % nm:
        nm -= 1
    return nm, vw_b // nm


def _serve_setup(run: RunConfig, mesh):
    cfg = run.arch
    assert cfg.stages == mesh.shape[S_AX], (cfg.stages, mesh.shape)
    assert cfg.tp in (1, mesh.shape[T_AX]), (cfg.tp, mesh.shape)
    cdt, cache_dt = cache_lib.serve_dtypes(run.compute_dtype,
                                           run.cache_dtype)
    return cfg, _serve_nm(run, mesh)[0], _meta_tree(cfg), cdt, cache_dt


def _stage_shards(cfg, mesh, params, cdt, shards):
    """Every data slot's shard views of params' blocks in the compute
    dtype: `shards` when the caller made them once (the Engine does), else
    made here (a cast copies f32 leaves, as JAX's cast in every step)."""
    if shards is not None:
        return shards
    blocks = _cast_tree(params["blocks"], cdt)
    return [lm.shard_blocks(cfg, blocks, mesh, d) for d in range(n_dp(mesh))]


def build_decode_step(run: RunConfig, mesh, *, pos_per_row: bool = False,
                      layout=None):
    """(step, pspecs, cspecs): step(params, batch{'inputs','cache','pos'},
    shards=None) -> (logits [B, 1, vocab] f32, cache), the cache written
    in place. batch['cache'] is serve.cache.shard_cache's per-slot nesting
    of a cache of cspecs (init_cache / init_paged, then shard_cache);
    shards the Engine's lm.shard_blocks views (None: made per call).

    pos a scalar (the aligned batch) or, with pos_per_row, a [B] vector
    (each row at its own depth; needs data = 1). layout: a PageLayout —
    the cache is the paged pool + block table (data = 1). Without a layout
    and under 16 rows the contiguous cache's sequence splits over the data
    slots and every data slot runs the whole batch: each computes the
    attention partial over its sequence shard and the partials merge
    (merge_decode_partials; with one data slot that is the plain decode,
    which the port runs through the kernel). From 16 rows the batch splits
    over the data slots instead."""
    cfg, nm, meta, cdt, cache_dt = _serve_setup(run, mesh)
    shp = run.shape
    pspecs = lm.param_specs(cfg)
    seq_sharded = (layout is None and shp.global_batch < 16
                   and D_AX in mesh.axis_names)
    ndp = n_dp(mesh)
    if layout is not None:
        _, cspecs = cache_lib.paged_struct(cfg, layout, dtype=cache_dt)
    else:
        _, cspecs = cache_lib.cache_struct(
            cfg, shp.global_batch, shp.seq_len,
            seq_shards=16 if seq_sharded else 1, dtype=cache_dt)
    if pos_per_row and ndp != 1:
        raise ValueError("pos_per_row decode needs the whole batch on every "
                         "data shard; use a data=1 mesh")
    if layout is not None and ndp != 1:
        raise ValueError("the paged pool is shared by the whole batch; "
                         "paged decode needs a data=1 mesh")

    def decode_step(params, batch, shards=None):
        shards = _stage_shards(cfg, mesh, params, cdt, shards)
        dev = params["final_norm"].device
        x = lm.embed_tokens(cfg, params, torch.as_tensor(
            batch["inputs"], device=dev)).to(cdt)
        caches = batch["cache"]
        B = x.shape[0]
        pos = torch.as_tensor(batch["pos"], dtype=torch.int64, device=dev)
        pos = pos.expand(B) if pos.dim() == 0 else pos
        if seq_sharded and ndp > 1:
            # every data slot holds a sequence shard of kv_full and runs
            # the whole batch; the rest of the state is whole over data, so
            # data slot 0's pipeline carries the other slots' shards
            offs = tuple(d * caches[d][0][0]["kv_full"][0].shape[2]
                         for d in range(1, ndp)) \
                if "kv_full" in caches[0][0][0] else None
            if offs:
                cache0 = [[dict(c, kv_merge=tuple(
                    caches[d][s][t]["kv_full"] for d in range(1, ndp)))
                    for t, c in enumerate(row)]
                    for s, row in enumerate(caches[0])]
            else:
                cache0 = caches[0]
            with mesh_lib.slot(data=0):
                y, _ = pipeline_wave(cfg, shards[0], x.to(_slot0(mesh, 0)),
                                     meta, mode="decode", nm=nm,
                                     cache=cache0, pos=pos, merge=offs,
                                     overlap=run.overlap,
                                     kernel_backend=run.kernel_backend)
                hid = _bcast_from_last(y, dev, cfg.stages)
        else:
            Bl = B // ndp
            outs = []
            issued = mesh_lib.issued_data_slots(ndp)
            for d in range(ndp):
                if d >= issued:           # the dry run reckons it
                    outs.append(mesh_lib.stand_in(outs[0]))
                    continue
                with mesh_lib.slot(data=d):
                    outs.append(_bcast_from_last(pipeline_wave(
                        cfg, shards[d],
                        x[d * Bl:(d + 1) * Bl].to(_slot0(mesh, d)), meta,
                        mode="decode", nm=nm, cache=caches[d],
                        pos=pos[d * Bl:(d + 1) * Bl], overlap=run.overlap,
                        kernel_backend=run.kernel_backend)[0], dev,
                        cfg.stages))
            hid = torch.cat(outs)
        return lm.logits_ref(cfg, params, hid), caches

    return decode_step, pspecs, cspecs


def build_prefill_step(run: RunConfig, mesh, *, cache_len: int = 0,
                       layout=None, var_len: bool = False):
    """(step, pspecs, cspecs): step(params, batch{'inputs','cache'
    [,'lens']}, shards=None) -> (last_logits [B, 1, vocab] f32, cache),
    the cache (shard_cache's nesting) written in place.

    cache_len > the shape's seq_len sizes the contiguous cache for the
    decode that follows (prompt_len inputs, prompt_len + gen positions;
    the prefill write zeroes the unwritten tail). layout: a PageLayout —
    prefill scatters K/V page by page through the cache's block table.
    var_len: batch['lens'] [B] per-row prompt lengths (right-padded
    prompts); cache writes stop at each row's length and the logits are
    each row's last real position's. Both need data = 1."""
    cfg, nm, meta, cdt, cache_dt = _serve_setup(run, mesh)
    shp = run.shape
    pspecs = lm.param_specs(cfg)
    if layout is not None:
        _, cspecs = cache_lib.paged_struct(cfg, layout, dtype=cache_dt)
    else:
        _, cspecs = cache_lib.cache_struct(cfg, shp.global_batch,
                                           cache_len or shp.seq_len,
                                           dtype=cache_dt)
    ndp = n_dp(mesh)
    if (layout is not None or var_len) and ndp != 1:
        raise ValueError("paged / variable-length prefill needs the whole "
                         "batch on every data shard; use a data=1 mesh")
    # under 16 rows the cache's batch is whole over data: data slot d's
    # rows are its rows of data slot 0's cache
    split = shp.global_batch >= 16

    def prefill_step(params, batch, shards=None):
        shards = _stage_shards(cfg, mesh, params, cdt, shards)
        dev = params["final_norm"].device
        x = lm.embed_tokens(cfg, params, torch.as_tensor(
            batch["inputs"], device=dev)).to(cdt)
        caches = batch["cache"]
        lens = None
        if var_len:
            lens = torch.as_tensor(batch["lens"], dtype=torch.int64,
                                   device=dev)
        Bl = x.shape[0] // ndp
        outs = []
        issued = mesh_lib.issued_data_slots(ndp)
        for d in range(ndp):
            if d >= issued:               # the dry run reckons it
                outs.append(mesh_lib.stand_in(outs[0]))
                continue
            with mesh_lib.slot(data=d):
                rows = slice(d * Bl, (d + 1) * Bl)
                cache_d = caches[d] if split or d == 0 else [
                    [cache_lib.slice_mb(c, d, Bl) for c in row]
                    for row in caches[0]]
                y, _ = pipeline_wave(
                    cfg, shards[d], x[rows].to(_slot0(mesh, d)), meta,
                    mode="prefill", nm=nm, cache=cache_d,
                    lens=None if lens is None else lens[rows],
                    overlap=run.overlap, kernel_backend=run.kernel_backend)
                if lens is None:
                    last = y[:, -1:]
                else:
                    idx = (lens[rows] - 1).clamp_min(0).to(y.device)
                    last = y[torch.arange(y.shape[0], device=y.device),
                             idx][:, None]
                outs.append(_bcast_from_last(last, dev, cfg.stages))
        return lm.logits_ref(cfg, params, torch.cat(outs)), caches

    return prefill_step, pspecs, cspecs


def _slot0(mesh, d: int):
    """Data slot d's stage-0, tp-0 device (where its pipeline starts)."""
    return mesh.devices.reshape(-1, mesh.shape[S_AX], mesh.shape[T_AX])[
        d, 0, 0]


def wave_grads(cfg: ArchConfig, nm: int, params, inputs, labels):
    """(mean microbatch loss as a 0-d tensor, grads shaped like params) of
    one wave at `params`. inputs / labels [B, S] split into nm microbatches
    of B / nm rows; a leaf no microbatch reaches gets zeros. Each
    microbatch's forward and backward is a `fwd_bwd` span (`mb=`) in the
    thread's bound trace scope (obs.span; none unbound)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    B = labels.shape[0]
    xw = inputs.reshape(nm, B // nm, *inputs.shape[1:])
    lw = labels.reshape(nm, B // nm, labels.shape[1])
    total = torch.zeros((), dtype=torch.float32, device=labels.device)
    for j in range(nm):
        with obs.span("fwd_bwd", mb=j):
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
    ids (numpy or tensors), moved to the params' device. The update is
    an `optim` span in the thread's bound trace scope."""

    def wave_step(params, opt_state, inputs, labels):
        dev = next(iter(params["blocks"].values())).device
        inputs = torch.as_tensor(inputs, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        loss, grads = wave_grads(cfg, nm, params, inputs, labels)
        with obs.span("optim"), torch.no_grad():
            deltas, opt_state = optimizer.update(grads, opt_state, params)
        return deltas, opt_state, loss

    return wave_step
