"""What the per-layer readers of the program's own spans share: a serve
run's per-decode-step totals from its ServeReport, and a training run's
spans by name over the window's waves. Each returns None where the run
holds nothing to read (a program without these spans or totals)."""
from __future__ import annotations

import statistics


def per_step_ms(run, *fields):
    """The ServeReport fields' sum per decode step (ms): host seconds the
    run's spans summed (api/serving.py, api/engine.py)."""
    if run.kind != "serve":
        return None
    rep = run.report
    vals = [getattr(rep, f, None) for f in fields]
    if None in vals or not rep.decode_steps or not sum(vals):
        return None
    return 1e3 * sum(vals) / rep.decode_steps


def durations(run, name, waves, track=None) -> dict:
    """{wave: [seconds]} of the `name` spans (on `track`, if given) whose
    `wave` arg is in `waves`."""
    out: dict = {}
    for ph, tr, nm, _, dur, args in run.spans:
        if ph == "X" and nm == name and (track is None or tr == track) \
                and args.get("wave") in waves:
            out.setdefault(args["wave"], []).append(dur)
    return out


def median_ms(by_wave: dict):
    """Median over waves of each wave's summed seconds (ms)."""
    sums = [sum(v) for v in by_wave.values()]
    return statistics.median(sums) * 1e3 if sums else None


def window_waves(run):
    """The waves begun in the window (run.waves), as a set."""
    return set(run.waves)


def window_pulls(run):
    """The wave args of the pulls that follow a window wave: a pull after
    wave w carries wave=w + 1, the wave that starts from its weights."""
    return {w + 1 for w in window_waves(run)}
