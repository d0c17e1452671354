"""Median over the window's waves of the summed forward and backward of
the wave's microbatches (ms): the `fwd_bwd` spans (one a microbatch, host
time: issue, and any wait inside), core/wave.py wave_grads."""
from hetbench import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.median_ms(spans.durations(run, "fwd_bwd",
                                           spans.window_waves(run)))
