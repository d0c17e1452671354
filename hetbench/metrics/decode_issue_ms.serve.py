"""Host time a decode step spends enqueueing the forward (ms a step): the
Engine's `engine issue` spans (ServeReport.decode_issue_s), api/engine.py
Engine.decode, over the run's decode steps."""
from hetbench import spans


def read(run):
    return spans.per_step_ms(run, "decode_issue_s")
