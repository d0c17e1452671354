"""Median pull in the window (ms): the wait for the VW's own push to land,
the parameter server's snapshot and the H2D (VWMetrics.pull_s; pull 0 is
the start-up pull, pull j follows wave 2j - 1 under pull_every 2)."""
import statistics


def read(run):
    if run.kind != "train":
        return None
    every = int(run.mix["sync"]["pull_every"])
    idx = [(w + 1) // every for w in run.waves if (w + 1) % every == 0]
    d = [run.pull_s[i] for i in idx if i < len(run.pull_s)]
    return statistics.median(d) * 1e3 if d else None
