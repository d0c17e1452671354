"""Median copy of w_global into the device params in a pull that follows
a window wave (ms): the `h2d` child of the VW's `pull` span, around
HostStaging.to_device (host fill of the pinned buffer, H2D, scatter),
runtime/staging.py."""
from hetbench import spans


def read(run):
    if run.kind != "train":
        return None
    return spans.median_ms(spans.durations(run, "h2d",
                                           spans.window_pulls(run)))
