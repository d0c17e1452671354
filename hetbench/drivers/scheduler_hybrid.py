"""Entry point `scheduler_hybrid`: the `scheduler` entry (drivers/
scheduler.py: Scheduler.run() over the paged pool, greedy, fifo, the
whole queue at t0, its spans as there) for a model whose layers are of
more than one kind and which keeps per-slot recurrent state. Four things
differ:

- the window opens as the Scheduler's second admission group begins, the
  first into a slot a finished request left, and holds the steps and
  groups that end in it (every request's gaps that end in it count for
  ITL, those admitted before it too): from t0 every slot is taken by the
  first group and none retires for the shortest answer's length, so a
  window that opened at t0 would spend most of its time before any
  admission and hold too few groups' stalls for ITL p95 to read one;
- the weights come from the family's own maker (`family.make`: a kind's
  leaves stacked over its own layers only);
- the Tap also keeps two rows' Mamba state after the run's first
  admission group, and the window's first group whole: its prompts and
  lengths as the frozen [max_batch, prompt_len] call took them (its idle
  rows too, which take expert capacity), its logits and up to two of its
  real rows' Mamba state after it;
- the decode check is one more decode step of the whole batch, taken
  after the window closes (and after its peak memory is read), from the
  program's pages, states and conv tails as the window left them: the
  state before a step is overwritten in place by it, and a copy of every
  slot's state before every step would cost the window its time and
  memory. Its inputs are the Scheduler's own: each slot still active
  feeds the token it picked at the last step, at the next position.

The configuration's family judges the calls (families/<family>.py)."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from hetbench import profiling, weights
from hetbench.drivers.scheduler import GIB, Tap, Timeline, _calls_in


class StateTap(Tap):
    """The `scheduler` entry's Tap, which also keeps the Mamba state of the
    first admission group's snapshot rows, stamps the second group's start
    (`t_open`) and keeps that group (`window`: the window's first)."""

    t_open = window = None

    def prefill_into(self, store, prompts, lens, slots, skip_pages=None):
        fresh = self.first is None
        opens = bool(self.prefills) and self.t_open is None
        if opens:
            self.t_open = time.monotonic()
        out = super().prefill_into(store, prompts, lens, slots,
                                   skip_pages=skip_pages)
        st = store.tree["ssm_state"]
        if fresh:
            self.first["state"] = {j: st[:, slots[j]].clone()
                                   for j in self.first["snap"]}
        if opens:
            real = np.asarray(lens)[:len(slots)]
            rows = sorted({0, int(np.argmax(real))})
            self.window = {"prompts": np.array(prompts), "lens":
                           np.array(lens), "n": len(slots), "logits": out,
                           "state": {j: st[:, slots[j]].clone()
                                     for j in rows}}
        return out

    def next_step(self, store):
        """One more decode step after the window, as the Scheduler would
        issue it: returns its inputs, the block table, the state and conv
        tails before it (copies) and its logits."""
        toks, pos, _, logits = self.last
        tab = store.tree["block_tab"].clone()
        active = (pos > 0) & (tab[:, 0] >= 0).cpu().numpy()
        nxt = logits.float().argmax(-1).cpu().numpy()
        toks = np.where(active, nxt, 0).astype(np.int32)
        pos = np.where(active, pos + 1, 0).astype(np.int32)
        before = {k: store.tree[k].clone() for k in ("ssm_state",
                                                      "conv_tail")}
        out, _ = self.decode_fn(toks[:, None], store, pos)
        dev = tab.device
        return dict(toks=torch.as_tensor(toks, device=dev),
                    pos=torch.as_tensor(pos, device=dev).long(), tab=tab,
                    logits=out, **before)


class WindowTimeline(Timeline):
    """The `scheduler` entry's Timeline over a window [t0, t1] that opens
    after the run began: built from the run's events, it keeps the decode
    steps and groups that end in the window, their tokens, and the
    inter-token gaps that end in it."""

    def __init__(self, events, t0, t1):
        super().__init__(events, t0, t1)
        admits, retires = {}, {}
        for ph, track, name, t, dur, args in events:
            if track == "sched" and name == "admit":
                admits[args["rid"]] = (args["step"], args["group"])
            elif track == "sched" and name == "retire":
                retires[args["rid"]] = args["step"]
        steps = sorted(self.dec)
        ends = np.array([self.dec[k][0] for k in steps])
        gaps = []
        for rid, (s_a, g) in admits.items():
            if g not in self.pre or not steps:
                continue
            s_end = retires.get(rid, steps[-1] + 1) - 1
            lo, hi = s_a - steps[0], min(s_end, steps[-1]) - steps[0]
            times = np.concatenate([[self.pre[g][0]], ends[lo:hi + 1]])
            gaps.append(np.diff(times)[times[1:] > t0])
        self.gaps = np.concatenate(gaps) if gaps else np.zeros(0)
        self.dec = {k: v for k, v in self.dec.items() if v[0] > t0}
        self.pre = {g: v for g, v in self.pre.items() if v[0] > t0}
        self.tokens = sum(v[1] for v in self.dec.values()) + \
            sum(v[1] for v in self.pre.values())
        self.admitted = sum(v[1] for v in self.pre.values())


def run(ctx):
    from repro_torch.api import Engine
    from repro_torch.api.plan import Plan, RunSpec, ServeSpec
    from repro_torch.api.serving import Request, Scheduler, StopServing
    from repro_torch.obs import Tracer
    from repro_torch.serve.memory import MemoryManager

    cell, mix, dev = ctx.cell, ctx.mix, ctx.device
    arch = cell.arch()
    z = weights.sizes(ctx.cfg, cell.family)
    B = int(mix["max_batch"])
    reqs = cell.kind.make(mix, ctx.cfg, ctx.seed)
    warm = cell.kind.warmup(mix, ctx.cfg, ctx.seed)
    plan = Plan(arch=arch, run=RunSpec(compute_dtype="bfloat16"),
                serve=ServeSpec(prompt_len=int(mix["prompt_len"]),
                                gen=int(mix["gen"]), max_batch=B,
                                temperature=0.0,
                                page_size=int(mix["page_size"]),
                                kernel_backend="cuda"))
    tracer = Tracer()
    eng = Engine(plan, params=cell.family.make(z, ctx.seed,
                                               dtype=torch.bfloat16,
                                               device=dev),
                 tracer=tracer, device=dev)
    sched = Scheduler(eng, policy=mix["policy"])
    for hook in ctx.hooks.get("serve", ()):
        hook(eng, sched)

    def request(r):
        return Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)

    sched.run([request(r) for r in warm])
    store = eng.serve_store()
    mm = MemoryManager(store, share_prefix=False, evict=False, preempt=False,
                       policy=mix["policy"], metrics=tracer.metrics)
    tap = StateTap(eng)
    sl = profiling.Slice()
    st = SimpleNamespace(close=None, steps=0, pre0=0)
    n_ev0 = len(tracer.events())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    def callback(step, active):
        now = time.monotonic()
        if st.close is None:
            if tap.t_open is None or now < tap.t_open + ctx.seconds:
                return
            st.close = now
            if not ctx.trace:
                raise StopServing
            st.pre0 = len(tap.prefills)
            sl.start()
            return
        st.steps += 1
        if (st.steps >= int(mix["profile_steps"])
                and len(tap.prefills) > st.pre0) \
                or st.steps >= 8 * int(mix["profile_steps"]):
            sl.stop()
            raise StopServing

    report = sched.run([request(r) for r in reqs], callback=callback,
                       store=store, mm=mm)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t_open = tap.t_open if tap.t_open is not None else time.monotonic()
    setup_s = t_open - ctx.t_process
    t_open_close = (t_open, st.close if st.close is not None
                    else time.monotonic())
    events = tracer.events()[n_ev0:]
    timeline = WindowTimeline(events, *t_open_close)
    prof = None
    if ctx.trace:
        phases = [(f"{ev[1]} {ev[2]}", ev[3], ev[3] + ev[4]) for ev in events
                  if ev[0] == "X" and ev[2] in ("decode_step", "prefill_group",
                                                 "decode", "prefill")]
        prof = sl.reduce(phases, outside="scheduler (admit, picks, retire)") \
            if sl.t1 is not None else None
    window = t_open_close[1] - t_open_close[0]
    in_window = [(t, v) for t, v in tap.prefills
                 if t_open_close[0] < t <= t_open_close[1]]
    dec_window = [(t, v) for t, v in tap.decodes
                  if t_open_close[0] < t <= t_open_close[1]]
    run = SimpleNamespace(
        kind="serve", z=z, family=cell.family, mix=mix, window=t_open_close,
        timeline=timeline,
        e2e={"serve_tokens_per_s": timeline.tokens / window,
             "itl_p95_ms": timeline.itl_p95_ms(), "setup_s": setup_s,
             "peak_mem_gib": peak / GIB},
        report=report, prefills=in_window, decodes=dec_window,
        prof_calls=(_calls_in(tap.prefills, sl), _calls_in(tap.decodes, sl))
        if ctx.trace else None,
        prof=prof, peak_bytes=peak, attempted=timeline.admitted,
        failed=report.failed_requests + report.shed
        + (st.close is None), checks={},
        control=None)
    t_check = time.monotonic()
    decode = tap.next_step(store) if tap.last is not None else None
    seen = SimpleNamespace(first=tap.first, window=tap.window,
                           steps=tap.steps, decode=decode, events=events,
                           report=report, store=store)
    tap.release()
    del eng, sched, tap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if decode is None or seen.first is None or seen.window is None:
        run.failed += 1
        return run
    run.checks, run.control = cell.family.check_serve(
        ctx, z, reqs, seen, ctx.hooks.get("control"))
    run.check_s = time.monotonic() - t_check
    return run
