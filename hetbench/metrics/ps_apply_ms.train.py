"""Median apply of a window wave's deltas on the parameter server (ms):
`ps push_apply` (the shard-grouped add and the clock's advance, on the
outbox thread under async push), core/param_server.py finish_push."""
from hetbench import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.median_ms(spans.durations(run, "push_apply",
                                           spans.window_waves(run), "ps"))
