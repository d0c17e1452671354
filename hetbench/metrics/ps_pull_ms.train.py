"""Median of the parameter server's side of a pull that follows a window
wave (ms): the snapshot of w_global, `ps pull_serve`,
core/param_server.py ParameterServer.pull."""
from hetbench import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.median_ms(spans.durations(run, "pull_serve",
                                           spans.window_pulls(run), "ps"))
