"""Share of the window spent in prefill groups (%): the Scheduler's
prefill_group spans (ServeReport.prefill_s's intervals) inside the
window, api/serving.py."""


def read(run):
    if run.kind != "serve":
        return None
    t0, t1 = run.window
    return 100.0 * run.timeline.prefill_seconds() / (t1 - t0)
