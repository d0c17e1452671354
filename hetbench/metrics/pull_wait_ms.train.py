"""Median wait, inside a pull that follows a window wave, for the VW's
in-flight push to land (ms): the `pull_wait` child of the VW's `pull`
span, runtime/virtual_worker.py."""
from hetbench import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.median_ms(spans.durations(run, "pull_wait",
                                           spans.window_pulls(run)))
