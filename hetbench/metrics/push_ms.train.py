"""Median push of the window's waves as the VW pays it (ms): the deltas'
D2H plus the hand-off to the outbox (VWMetrics.push_s),
core/param_server.py and runtime/staging.py."""
import statistics


def read(run):
    if run.kind != "train":
        return None
    d = [run.push_s[w] for w in run.waves if w < len(run.push_s)]
    return statistics.median(d) * 1e3 if d else None
