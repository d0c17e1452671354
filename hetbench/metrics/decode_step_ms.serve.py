"""Median host gap between consecutive decode steps with no prefill group
between them (ms): the Scheduler's decode_step spans, api/serving.py."""
import statistics


def read(run):
    if run.kind != "serve":
        return None
    d = run.timeline.decode_step_gaps()
    return statistics.median(d) * 1e3 if d else None
