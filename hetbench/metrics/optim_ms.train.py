"""Median over the window's waves of the optimizer's update (ms): the
`optim` span around optimizer.update, core/wave.py
build_local_wave_step."""
from hetbench import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.median_ms(spans.durations(run, "optim",
                                           spans.window_waves(run)))
