"""repro_torch.obs — tracing + metrics (a plain-Python copy of repro.obs).

The Engine and the Scheduler record spans (prefill, decode steps, admit /
refuse / retire instants) and metrics (TTFT histogram, preemptions,
evictions) through a Tracer; `NULL_TRACER` records nothing and allocates
nothing on the hot path.

    from repro_torch.obs import Tracer
    tr = Tracer()
    report = Scheduler(Engine(plan, tracer=tr)).run(requests)
    tr.export("trace.json")            # Chrome trace JSON; open in Perfetto

Spans on one track nest, and a span's self time is its duration minus its
children's. The serve step, per decode step:

    sched decode_step          the batched step, logits on the host
      engine decode            (a call below the Scheduler's span)
        engine issue           the forward enqueued
        engine drain           the wait for the device (traced runs only)
      sched d2h                the logits' copy to the host
    sched pick                 the host picks, retiring, step bookkeeping
    sched admission            one admission round: order, pages, padding
    sched prefill_group        the prefill of the admitted rows (`rows=`,
                               padded to `width=`)

ServeReport carries each run's totals of these (`decode_issue_s`,
`decode_drain_s`, `logits_d2h_s`, `pick_s`, `admit_s`) and the prefill's
real and padded tokens. The training fleet, per wave on the worker's
track (`vw0`, every span with `wave=`):

    gate_wait                  the WSP staleness gate
    wave                       self time: rows' load, the loss sync
      fwd_bwd                  one per microbatch (`mb=`)
      optim                    the optimizer's update
    pull                       every pull_every waves
      pull_wait                the in-flight push landing
      h2d                      w_global into the device params
    ps push_apply, ps pull_serve   the parameter server's side (`wave=`)

plus push spans on `vw0/outbox`, gate waits, the per-wave staleness
audited against the Plan's D; fault injection and recovery add instants
and the `fault/*` counters. Code without a tracer records into the
thread's scope that `Tracer.bind(track, **ids)` sets, through `span()`.
While a torch.profiler records (with CPU activity), every span is also a
`record_function` range named `track/name`. `python -m
repro_torch.obs.summary trace.json` prints busy time per track, each span
name's self time, the staleness histogram (exit 1 when it exceeds D),
links, faults and TTFT.
"""
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Tracer, span

__all__ = [
    "Histogram", "MetricsRegistry", "NULL_SPAN", "NULL_TRACER", "Tracer",
    "span",
]
