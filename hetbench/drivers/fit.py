"""Entry point `fit`: HetPipe training through Engine.fit() on the
threads backend, one virtual worker (VW) against the host parameter
server under the mix's WSP policy.

Set-up builds the Engine once, with the benchmark's weights and the
mix's rows as its data source, and starts fit(): the first `warm_waves`
waves run through the window's own call and feed, and the first
`checked_waves` of them are recorded for the reference. The window opens
as wave `warm_waves` begins and closes when the VW, stopped through
Engine.stop_event `seconds` later, has finished its wave and its last
push has landed. train_tokens_per_s is the rows of every wave begun in the
window over that whole time."""
from __future__ import annotations

import gc
import threading
import time
from types import SimpleNamespace

import torch

from hetbench import profiling, weights
from hetbench.reference import compare, prec, train as ref_train

GIB = 2 ** 30


def _tree_items(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _tree_items(v, f"{prefix}{k}/") if isinstance(v, dict) \
            else [(f"{prefix}{k}", v)]
    return out


class Recorder:
    """Wraps the wave step the Engine is given: stamps each call, keeps the
    losses, the first gradient's norms as the optimizer's state holds them
    after one step (m / (1 - b1)) and the weights the fourth wave starts
    from, on the host."""

    def __init__(self, step, b1: float, checked: int):
        self.step, self.b1, self.checked = step, b1, checked
        self.entries, self.losses = [], []
        self.g1 = None
        self.w_after = None
        self.cond = threading.Condition()

    def __call__(self, params, opt_state, x, y):
        i = len(self.entries)
        with self.cond:
            self.entries.append(time.monotonic())
            self.cond.notify_all()
        if i == self.checked:
            self.w_after = {n: t.detach().to("cpu", copy=True)
                            for n, t in _tree_items(params)}
        deltas, opt_state, loss = self.step(params, opt_state, x, y)
        self.losses.append(float(loss))
        if i == 0:
            self.g1 = {n: float(torch.linalg.vector_norm(m.float()))
                       / (1 - self.b1)
                       for n, m in _tree_items(opt_state["m"])}
        return deltas, opt_state, loss

    def wait_for(self, n: int, thread) -> float:
        """The entry time of call n (blocks until it begins)."""
        with self.cond:
            while len(self.entries) <= n:
                if not thread.is_alive():
                    raise RuntimeError("fit() ended before wave %d" % n)
                self.cond.wait(0.5)
            return self.entries[n]


def run(ctx):
    from repro_torch.api import Engine
    from repro_torch.api.plan import (ClusterSpec, PartitionSpec, Plan,
                                      RunSpec)
    from repro_torch.api.sync import WSP
    from repro_torch.core.wave import build_local_wave_step
    from repro_torch.obs import Tracer
    from repro_torch.optim import make_optimizer

    cell, mix, dev = ctx.cell, ctx.mix, ctx.device
    arch = cell.arch()
    z = weights.sizes(ctx.cfg, cell.family)
    opt = mix["optimizer"]
    warm, checked = int(mix["warm_waves"]), int(mix["checked_waves"])
    nm = int(mix["microbatches"])
    source = cell.kind.make(mix, ctx.cfg, ctx.seed)
    params = weights.make(ctx.cfg, ctx.seed, dtype=torch.float32, device=dev,
                          family=cell.family)
    plan = Plan(arch=arch, cluster=ClusterSpec(num_vw=1),
                sync=WSP(**mix["sync"]),
                partition=PartitionSpec(num_microbatches=nm),
                run=RunSpec(max_waves=1 << 30, batch=mix["rows_per_wave"],
                            seq=mix["seq"], optimizer=opt["name"],
                            lr=opt["lr"], weight_decay=opt["weight_decay"]))
    optimizer = make_optimizer(opt["name"], opt["lr"], opt["weight_decay"])
    step = build_local_wave_step(arch, nm, optimizer)
    step = ctx.hooks.get("wave_step", lambda s: s)(step)
    tracer = Tracer() if ctx.trace else None
    sl = profiling.Slice()

    rec = Recorder(step, opt["b1"], checked)
    eng = Engine(plan, params=params, wave_step=rec, optimizer=optimizer,
                 tracer=tracer, device=dev)
    del params
    # the Engine takes its data from a source object; it has no public
    # seam for one yet
    eng._source = source
    box = {}

    def fit():
        try:
            box["report"] = eng.fit()
        except BaseException as e:          # surfaced below
            box["error"] = e

    th = threading.Thread(target=fit, name="hetbench-fit")
    th.start()
    t_open = rec.wait_for(warm, th)
    setup_s = t_open - ctx.t_process
    deadline = t_open + ctx.seconds
    traced = None
    if ctx.trace:
        # the window is the waves begun before the deadline; the first wave
        # begun after it is the VW's last, and its first `profile_s` are
        # traced (a whole wave of ~10^5 eager launches would outgrow the
        # run's time under the profiler)
        traced = warm
        while rec.wait_for(traced, th) < deadline:
            traced += 1
        eng.stop_event.set()
        sl.start()
        time.sleep(float(mix.get("profile_s", 5.0)))
        sl.stop()
    else:
        time.sleep(max(0.0, deadline - time.monotonic()))
        eng.stop_event.set()
    th.join()
    t_end = time.monotonic()
    if "error" in box:
        raise box["error"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    vw = next(iter(eng.workers.values()))
    n_calls = len(rec.entries)
    # the window's waves and its end: every wave begun in it, up to the
    # VW's stop (untraced), or up to the traced wave (traced)
    last = traced if ctx.trace else n_calls
    t_close = rec.entries[traced] if ctx.trace else t_end
    n_waves = last - warm
    tokens = n_waves * cell.kind.tokens_per_wave(mix)
    window = t_close - t_open
    prof = None
    if ctx.trace:
        # the VW thread's own spans name the device's idle gaps
        phases = [(f"vw {ev[2]}", ev[3], ev[3] + ev[4])
                  for ev in tracer.events() if ev[0] == "X"
                  and ev[1] == vw.wid and ev[2] in ("wave", "pull",
                                                     "gate_wait")]
        prof = sl.reduce(phases, outside="vw between phases (push D2H, "
                         "enqueue, bookkeeping)")
    run = SimpleNamespace(
        kind="train", z=z, mix=mix, window=(t_open, t_close),
        e2e={"train_tokens_per_s": tokens / window, "setup_s": setup_s,
             "peak_mem_gib": peak / GIB},
        waves=list(range(warm, last)),
        wave_flops=cell.family.train_flops(z, mix["rows_per_wave"],
                                           mix["seq"]),
        family=cell.family,
        push_s=list(vw.metrics.push_s), pull_s=list(vw.metrics.pull_s),
        spans=tracer.events() if tracer is not None else [],
        prof=prof, peak_bytes=peak, attempted=max(n_waves, 0), failed=0,
        checks={})
    if n_waves < 1:
        run.failed = 1
    first = dict(losses=rec.losses[:checked], g1=rec.g1, w_after=rec.w_after)
    del eng, vw, rec, step, box
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    run.checks, run.control = check(ctx, z, source, first,
                                    ctx.hooks.get("control"))
    run.check_s = time.monotonic() - t_check
    return run


def check(ctx, z, source, first, mode=None):
    """The first waves against the reference: the relative gap of each
    wave's loss, and by the leaves the first gradient's norm and the norm
    of the weights' change over the checked waves. `first` holds the
    program's record of them (None: no program run). With `mode`, a
    reference precision or a planted fault ("fault:<name>", in float32),
    the control's own waves are read against the reference the same way.
    Returns (readings, control readings)."""
    mix, dev = ctx.mix, ctx.device
    n = int(mix["checked_waves"])
    w0 = weights.make(ctx.cfg, ctx.seed, dtype=torch.float32, device=dev,
                      family=ctx.cell.family)
    batches = [tuple(torch.as_tensor(a, device=dev) for a in source.wave(w))
               for w in range(n)]
    before = dict(ref_train.leaves(w0))

    def reference(mode):
        fault = mode[6:] if mode.startswith("fault:") else None
        with prec.exact_f32():
            return ref_train.waves(
                z, w0, batches, int(mix["microbatches"]), mix["optimizer"],
                prec.Prec("f32" if fault else mode),
                ctx.cell.family.train_loss, fault=fault,
                pull_every=int(mix["sync"]["pull_every"]))

    losses, g1, after = reference("f32")
    skip = compare.quiet_leaves(g1)
    moved_ref = compare.change_norms(after, before)
    notes = {"quiet_leaves": skip}

    def readings(got_losses, got_g1, got_after):
        """loss1: the first wave's loss (the later waves' swing with the
        elements AdamW moves by round-off, see `moved`); grad1: the first
        gradient by the worst leaf; change3: the weights' change over the
        checked waves by the median leaf (the worst leaf swings the same
        way); the rest are read for the record, not compared."""
        if len(got_losses) < n or got_g1 is None or got_after is None:
            return {"loss1": float("inf"), "grad1": float("inf"),
                    "change3": float("inf")}
        gaps = [abs(a - b) / abs(b) for a, b in zip(got_losses, losses)]
        moved = compare.change_norms(got_after, before)
        worst, leaf = compare.worst_leaf(moved, moved_ref, skip)
        out = {"loss1": gaps[0],
               "grad1": compare.worst_leaf(got_g1, g1, skip)[0],
               "change3": compare.median_leaf(moved, moved_ref, skip),
               "loss_later": max(gaps[1:], default=0.0),
               "change3_worst": worst,
               "moved_apart": compare.moved_apart(
                   got_after, after, before, mix["optimizer"]["lr"])}
        notes["change3_worst_leaf"] = leaf
        return out

    checks = readings(first["losses"], first["g1"], first["w_after"]) \
        if first is not None else {}
    control = readings(*reference(mode)) if mode else {}
    ctx.notes = notes
    return checks, control


def control(ctx) -> dict:
    """The control's readings alone, with no program run (training's
    readings need no window): the reference in precision
    ctx.hooks["control"], or with a planted fault, against the float32
    reference."""
    z = weights.sizes(ctx.cfg, ctx.cell.family)
    source = ctx.cell.kind.make(ctx.mix, ctx.cfg, ctx.seed)
    return check(ctx, z, source, None, ctx.hooks["control"])[1]
