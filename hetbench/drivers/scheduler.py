"""Entry point `scheduler`: continuous batching through Scheduler.run()
over the paged pool, greedy, fifo, the whole queue at t0.

Set-up builds the Engine with the benchmark's weights (bfloat16, kernels
"cuda") and serves a warm-up queue of two admission groups at the cell's
own shapes. The window opens as Scheduler.run() starts on the mix's
queue, with a pool made in set-up, and closes at the first decode step
that ends `seconds` later, whose callback raises StopServing. Tokens and
their times are read from the Scheduler's own spans (the Tracer is on in
every run). The Engine's prefill_into / decode are observed through
thin wrappers that keep the inputs and outputs the check needs; the
configuration's family (families/<family>.py) judges them."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from hetbench import profiling, weights

GIB = 2 ** 30


class Tap:
    """Wraps an Engine's prefill_into and decode: stamps each call with
    its real rows and keeps the first admission group's logits (and, with
    a paged pool, a copy of two of its rows' pages), the tokens every
    decode step was fed, and the last decode step's inputs, block table
    and logits."""

    def __init__(self, eng):
        self.prefill_fn, self.decode_fn = eng.prefill_into, eng.decode
        self.prefills, self.decodes = [], []
        self.first = None
        self.steps = []
        self.last = None
        eng.prefill_into, eng.decode = self.prefill_into, self.decode

    def prefill_into(self, store, prompts, lens, slots, skip_pages=None):
        out = self.prefill_fn(store, prompts, lens, slots,
                              skip_pages=skip_pages)
        n = len(slots)
        real = np.asarray(lens)[:n].copy()
        self.prefills.append((time.monotonic(), real))
        if self.first is None:
            self.first = {"lens": real, "slots": list(slots), "snap": {},
                          "logits": out}
            if "kv_full" in store.tree:
                rows = sorted({0, int(np.argmax(real))})
                tab = store.tree["block_tab"]
                ps = store.layout.page_size
                for j in rows:
                    pages = tab[slots[j], :-(-int(real[j]) // ps)].long()
                    self.first["snap"][j] = tuple(
                        pool[:, pages].clone() for pool in store.tree["kv_full"])
        return out

    def decode(self, tokens, cache, pos):
        tab = cache.tree["block_tab"].clone() \
            if "block_tab" in getattr(cache, "tree", {}) else None
        logits, out = self.decode_fn(tokens, cache, pos)
        toks = np.asarray(tokens)[:, 0].copy()
        pos = np.asarray(pos).copy()
        self.steps.append(toks)
        self.last = (toks, pos, tab, logits)
        self.decodes.append((time.monotonic(), pos[pos > 0]))
        return logits, out

    def release(self):
        self.prefill_fn = self.decode_fn = None


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
    eng = Engine(plan, params=weights.make(ctx.cfg, ctx.seed,
                                           dtype=torch.bfloat16, device=dev,
                                           family=cell.family),
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
    tap = Tap(eng)
    sl = profiling.Slice()
    st = SimpleNamespace(close=None, steps=0, pre0=0)
    n_ev0 = len(tracer.events())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_open = time.monotonic()
    setup_s = t_open - ctx.t_process
    deadline = t_open + ctx.seconds

    def callback(step, active):
        now = time.monotonic()
        if st.close is None:
            if now < deadline:
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
    t_open_close = (t_open, st.close if st.close is not None
                    else time.monotonic())
    events = tracer.events()[n_ev0:]
    timeline = Timeline(events, *t_open_close)
    prof = None
    if ctx.trace:
        phases = [(f"{ev[1]} {ev[2]}", ev[3], ev[3] + ev[4]) for ev in events
                  if ev[0] == "X" and ev[2] in ("decode_step", "prefill_group",
                                                 "decode", "prefill")]
        prof = sl.reduce(phases, outside="scheduler (admit, picks, retire)") \
            if sl.t1 is not None else None
    window = t_open_close[1] - t_open_close[0]
    in_window = [(t, v) for t, v in tap.prefills if t <= t_open_close[1]]
    dec_window = [(t, v) for t, v in tap.decodes if t <= t_open_close[1]]
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
    seen = SimpleNamespace(first=tap.first, steps=tap.steps, last=tap.last,
                           events=events, report=report, store=store)
    tap.release()
    del eng, sched, tap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    run.checks, run.control = cell.family.check_serve(
        ctx, z, reqs, seen, ctx.hooks.get("control"))
    run.check_s = time.monotonic() - t_check
    return run


def _calls_in(calls, sl):
    """The calls that ended inside the profiled slice."""
    if sl.t0 is None or sl.t1 is None:
        return []
    return [v for t, v in calls if sl.t0 <= t <= sl.t1]


class Timeline:
    """Tokens and their times from the Scheduler's spans and instants in
    the window [t0, t1]: a prefill group's end gives each admitted
    request its first token, a decode step's end a token to every active
    one."""

    def __init__(self, events, t0, t1):
        dec, pre, admits, retires = {}, {}, {}, {}
        for ph, track, name, t, dur, args in events:
            if track != "sched":
                continue
            if name == "decode_step":
                dec[args["step"]] = (t + dur, args["slots"], t)
            elif name == "prefill_group":
                pre[args["group"]] = (t + dur, args["rows"], t, dur)
            elif name == "admit":
                admits[args["rid"]] = (args["step"], args["group"])
            elif name == "retire":
                retires[args["rid"]] = args["step"]
        self.t0, self.t1 = t0, t1
        self.dec = {k: v for k, v in dec.items() if v[0] <= t1}
        self.pre = {g: v for g, v in pre.items() if v[0] <= t1}
        self.tokens = sum(v[1] for v in self.dec.values()) + \
            sum(v[1] for v in self.pre.values())
        self.admitted = sum(v[1] for v in self.pre.values())
        steps = sorted(self.dec)
        self.gaps = []
        if not steps:
            return
        ends = np.array([self.dec[k][0] for k in steps])
        first_step = steps[0]
        for rid, (s_a, g) in admits.items():
            if g not in self.pre:
                continue
            s_end = retires.get(rid, steps[-1] + 1) - 1
            lo, hi = s_a - first_step, min(s_end, steps[-1]) - first_step
            times = np.concatenate([[self.pre[g][0]], ends[lo:hi + 1]])
            self.gaps.append(np.diff(times))
        self.gaps = np.concatenate(self.gaps) if self.gaps else np.zeros(0)

    def itl_p95_ms(self):
        return float(np.percentile(self.gaps, 95) * 1e3) if len(self.gaps) \
            else None

    def decode_step_gaps(self):
        """End-to-end gaps between consecutive decode steps with no prefill
        group between them."""
        steps = sorted(self.dec)
        starts = sorted(v[2] for v in self.pre.values())
        out = []
        for a, b in zip(steps, steps[1:]):
            ta, tb = self.dec[a][0], self.dec[b][0]
            if b == a + 1 and not any(ta <= s < tb for s in starts):
                out.append(tb - ta)
        return out

    def prefill_seconds(self):
        return sum(v[3] for v in self.pre.values())
