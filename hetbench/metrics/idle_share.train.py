"""Share of one whole traced wave (compute, push, pull, gate) in which no
kernel or copy ran on the card (%), from torch.profiler."""


def read(run):
    if run.kind != "train" or run.prof is None or not run.prof["busy_s"]:
        return None
    return 100.0 * (1.0 - run.prof["busy_s"] / run.prof["window_s"])
