"""Chrome-trace-event JSON export (the format Perfetto / chrome://tracing
load) plus the schema validator tests and CI share.

The exported document is the standard object form:

    {"traceEvents": [...], "displayTimeUnit": "ms", "telemetry": {...}}

One process (pid 1); each tracer track becomes one thread row (tid assigned
in first-appearance order) named via 'M' thread_name metadata, so Perfetto
shows one labeled row per VW / stage / link / scheduler. Spans are complete
('X') events, instants 'i', counter samples 'C'. Timestamps are in
microseconds relative to the earliest event (Chrome's expected unit).
"""
from __future__ import annotations

import json

PID = 1


def to_chrome(events, *, telemetry=None) -> dict:
    """events: Tracer event tuples (ph, track, name, t0_s, dur_s, args)."""
    tids: dict[str, int] = {}
    out = [{"ph": "M", "name": "process_name", "pid": PID, "tid": 0,
            "args": {"name": "repro"}}]
    t_base = min((e[3] for e in events), default=0.0)

    def tid(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": PID,
                        "tid": tids[track], "args": {"name": track}})
        return tids[track]

    for ph, track, name, t0, dur, args in sorted(events, key=lambda e: e[3]):
        ev = {"ph": ph, "name": name, "cat": "repro", "pid": PID,
              "tid": tid(track), "ts": (t0 - t_base) * 1e6,
              "args": dict(args)}
        if ph == "X":
            ev["dur"] = dur * 1e6
        elif ph == "i":
            ev["s"] = "t"                  # thread-scoped instant
        out.append(ev)
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if telemetry is not None:
        doc["telemetry"] = telemetry
    return doc


def write_chrome(events, path: str, *, telemetry=None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome(events, telemetry=telemetry), f)
    return path


def validate_chrome(doc) -> None:
    """Raise ValueError unless `doc` is well-formed Chrome trace JSON of the
    shape this exporter writes (the contract Perfetto ingestion needs)."""
    def fail(msg):
        raise ValueError(f"invalid Chrome trace: {msg}")

    if not isinstance(doc, dict) or "traceEvents" not in doc:
        fail("top level must be an object with a 'traceEvents' list")
    evs = doc["traceEvents"]
    if not isinstance(evs, list) or not evs:
        fail("'traceEvents' must be a non-empty list")
    named_tids = set()
    for ev in evs:
        if not isinstance(ev, dict):
            fail(f"event is not an object: {ev!r}")
        for key in ("ph", "name", "pid"):
            if key not in ev:
                fail(f"event missing {key!r}: {ev!r}")
        ph = ev["ph"]
        if ph not in ("M", "X", "i", "C"):
            fail(f"unknown event phase {ph!r}")
        if ph == "M":
            if ev["name"] == "thread_name":
                named_tids.add(ev["tid"])
            continue
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            fail(f"event needs a non-negative numeric ts: {ev!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            fail(f"'X' event needs a non-negative numeric dur: {ev!r}")
        if not isinstance(ev.get("args", {}), dict):
            fail(f"args must be an object: {ev!r}")
        if ev.get("tid") not in named_tids:
            fail(f"event on unnamed track tid={ev.get('tid')!r}")
    tel = doc.get("telemetry")
    if tel is not None:
        if not isinstance(tel, dict):
            fail("'telemetry' must be an object")
        for section in ("counters", "gauges", "histograms"):
            if section in tel and not isinstance(tel[section], dict):
                fail(f"telemetry.{section} must be an object")


def load(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    validate_chrome(doc)
    return doc
