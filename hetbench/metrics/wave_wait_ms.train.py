"""Median over the window's waves of the `wave` span's self time (ms): the
span less its `fwd_bwd` and `optim` children, which leaves the rows' load
and the wait at the loss sync (the device draining what the host issued),
runtime/virtual_worker.py."""
import statistics

from hetbench import spans


def read(run):
    if run.kind != "train":
        return None
    waves = spans.window_waves(run)
    whole = spans.durations(run, "wave", waves)
    parts = spans.durations(run, "fwd_bwd", waves)
    for w, d in spans.durations(run, "optim", waves).items():
        parts.setdefault(w, []).extend(d)
    own = [sum(whole[w]) - sum(parts[w]) for w in whole if w in parts]
    return statistics.median(own) * 1e3 if own else None
