"""Median wave compute of the window's waves (ms): the VW's `wave` span
(loader, the wave step, the float(loss) sync), runtime/virtual_worker.py."""
import statistics


def read(run):
    if run.kind != "train":
        return None
    t0, t1 = run.window
    d = [ev[4] for ev in run.spans if ev[0] == "X" and ev[2] == "wave"
         and t0 <= ev[3] and ev[3] + ev[4] <= t1]
    return statistics.median(d) * 1e3 if d else None
