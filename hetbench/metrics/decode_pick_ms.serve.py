"""Host time a decode step spends on its logits after the device (ms a
step): their copy to the host (`sched d2h`) plus the picks, retiring and
step bookkeeping (`sched pick`); ServeReport.logits_d2h_s + pick_s,
api/serving.py Scheduler.run."""
from hetbench import spans


def read(run):
    return spans.per_step_ms(run, "logits_d2h_s", "pick_s")
