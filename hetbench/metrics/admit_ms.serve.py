"""Host time of the admission rounds per decode step (ms a step): the
order, the pages and the padded prompt array (`sched admission`,
ServeReport.admit_s; the prefill itself is not in it), api/serving.py."""
from hetbench import spans


def read(run):
    return spans.per_step_ms(run, "admit_s")
