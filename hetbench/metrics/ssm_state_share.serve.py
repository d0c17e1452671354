"""Share of the run's peak device memory that the slots' recurrent state
holds (%): ServeReport.ssm_state_bytes (the Mamba state and conv tails of
every slot, serve/cache.py CacheStore.stats) over the peak. Nothing to
read where the program reports no such state."""


def read(run):
    if run.kind != "serve" or not run.peak_bytes:
        return None
    held = getattr(run.report, "ssm_state_bytes", 0)
    return 100.0 * held / run.peak_bytes if held else None
