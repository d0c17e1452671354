"""repro_torch.obs — tracing + metrics (a plain-Python copy of repro.obs).

The Engine and the Scheduler record spans (prefill, decode steps, admit /
refuse / retire instants) and metrics (TTFT histogram, preemptions,
evictions) through a Tracer; `NULL_TRACER` records nothing and allocates
nothing on the hot path.

    from repro_torch.obs import Tracer
    tr = Tracer()
    report = Scheduler(Engine(plan, tracer=tr)).run(requests)
    tr.export("trace.json")            # Chrome trace JSON; open in Perfetto

The training fleet records wave / push / pull spans, gate waits and the
per-wave staleness audited against the Plan's D; fault injection and
recovery add instants and the `fault/*` counters. `python -m
repro_torch.obs.summary trace.json` prints busy time per track, the
staleness histogram (exit 1 when it exceeds D), links, faults and TTFT.
"""
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, Tracer,
                                   emit_pipeline_ticks)

__all__ = [
    "Histogram", "MetricsRegistry", "NULL_SPAN", "NULL_TRACER", "Tracer",
    "emit_pipeline_ticks",
]
