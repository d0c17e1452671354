"""The chat window's serving rate (tokens/s), per layer: output tokens
made in the window over the window (drivers/scheduler.py), the number
that is no end-to-end metric in the host-bound chat cell, whose runs
spread with the host's stalls."""


def read(run):
    if run.kind != "serve" or not run.timeline.tokens:
        return None
    return run.e2e["serve_tokens_per_s"]
