"""Share of the traced slice (decode steps around at least one prefill
group) in which no kernel or copy ran on the card (%), from
torch.profiler."""


def read(run):
    if run.kind != "serve" or run.prof is None or not run.prof["busy_s"]:
        return None
    return 100.0 * (1.0 - run.prof["busy_s"] / run.prof["window_s"])
