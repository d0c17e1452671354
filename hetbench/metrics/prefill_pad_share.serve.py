"""Share of the prefill's token slots that are padding (%): 100 x (1 -
real prompt tokens / (max_batch x prompt_len) a call), over every prefill
call of the run (ServeReport.prefill_tokens, prefill_slot_tokens),
api/serving.py Scheduler.run."""


def read(run):
    if run.kind != "serve":
        return None
    real = getattr(run.report, "prefill_tokens", None)
    slots = getattr(run.report, "prefill_slot_tokens", None)
    if real is None or not slots:
        return None
    return 100.0 * (1.0 - real / slots)
