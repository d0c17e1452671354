"""The window's training rate (tokens/s), per layer: the rows of every
wave begun in the window over the window (drivers/fit.py), the number
that is no end-to-end metric because one window holds two or three
waves and a pull, and its count of them moves with the host."""


def read(run):
    if run.kind != "train" or not run.waves:
        return None
    return run.e2e["train_tokens_per_s"]
