"""Time a decode step waits for the device once the forward is enqueued
(ms a step): the Engine's `engine drain` spans, the synchronize the
traced Engine already pays (ServeReport.decode_drain_s), api/engine.py."""
from hetbench import spans


def read(run):
    return spans.per_step_ms(run, "decode_drain_s")
