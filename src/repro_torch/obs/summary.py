"""Text summary of an exported trace: the CLI companion to Perfetto (a copy
of repro.obs.summary over repro_torch.obs.export.load).

    PYTHONPATH=src python -m repro_torch.obs.summary trace.json

Prints per-track busy time, each span name's self time by track (its
duration minus its children's: spans nest on a track), the WSP staleness
histogram (audited against the recorded D bound when present), per-link
traffic/utilization, the fault/recovery counters (repro_torch.faults: drops,
retries, crashes, evictions vs rejoins) and serve TTFT — everything the
ROADMAP's measurement items report through. Exits non-zero on a malformed
trace or a staleness audit failure — chaos runs included: an injected
fault whose recovery broke the D bound fails the audit here.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from repro_torch.obs.export import load


def _fmt_s(s: float) -> str:
    return f"{s * 1e3:.1f}ms" if s < 1.0 else f"{s:.2f}s"


def _hist_line(h: dict) -> str:
    pairs = []
    edges = list(h["bounds"]) + ["inf"]
    for edge, c in zip(edges, h["counts"]):
        if c:
            pairs.append(f"<={edge}:{c}")
    return " ".join(pairs) if pairs else "(empty)"


def self_times(doc: dict) -> dict:
    """{(track, name): [self_s, total_s, count]} over the trace's spans: a
    span's self time is its duration less its children's, the spans on
    its track that lie inside it (the innermost enclosing span is the
    parent)."""
    tracks = {ev["tid"]: ev["args"]["name"] for ev in doc["traceEvents"]
              if ev["ph"] == "M" and ev["name"] == "thread_name"}
    by_tid = defaultdict(list)
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            by_tid[ev["tid"]].append((ev["ts"], -ev["dur"], ev["name"]))
    out: dict = {}
    eps = 1e-3                                  # microseconds
    for tid, spans in by_tid.items():
        track = tracks.get(tid, f"tid{tid}")
        stack: list = []                        # [end, key] of open spans
        for ts, neg, name in sorted(spans):
            dur = -neg
            while stack and stack[-1][0] <= ts + eps:
                stack.pop()
            row = out.setdefault((track, name), [0.0, 0.0, 0])
            row[0] += dur / 1e6
            row[1] += dur / 1e6
            row[2] += 1
            if stack and ts + dur <= stack[-1][0] + eps:
                out[stack[-1][1]][0] -= dur / 1e6
            stack.append([ts + dur, (track, name)])
    return out


def summarize(doc: dict) -> list[str]:
    lines = []
    tracks: dict[int, str] = {}
    busy = defaultdict(float)
    span_count = defaultdict(int)
    t_lo, t_hi = None, 0.0
    for ev in doc["traceEvents"]:
        if ev["ph"] == "M":
            if ev["name"] == "thread_name":
                tracks[ev["tid"]] = ev["args"]["name"]
            continue
        t_lo = ev["ts"] if t_lo is None else min(t_lo, ev["ts"])
        t_hi = max(t_hi, ev["ts"] + ev.get("dur", 0.0))
        if ev["ph"] == "X":
            name = tracks.get(ev["tid"], f"tid{ev['tid']}")
            busy[name] += ev["dur"] / 1e6
            span_count[name] += 1
    wall = ((t_hi - (t_lo or 0.0)) / 1e6) or 1e-9
    lines.append(f"trace: {len(doc['traceEvents'])} events, "
                 f"{len(tracks)} tracks, span {_fmt_s(wall)}")
    for name in sorted(busy, key=busy.get, reverse=True):
        lines.append(f"  {name:<24s} busy={_fmt_s(busy[name]):>9s} "
                     f"({min(1.0, busy[name] / wall):5.1%})  "
                     f"spans={span_count[name]}")

    selfs = self_times(doc)
    for track, name in sorted(selfs, key=lambda k: (k[0], -selfs[k][0])):
        own, total, n = selfs[(track, name)]
        lines.append(f"  self {track + ' ' + name:<32s} "
                     f"self={_fmt_s(max(0.0, own)):<9s} "
                     f"total={_fmt_s(total):<9s} n={n}")

    tel = doc.get("telemetry") or {}
    hists = tel.get("histograms", {})
    gauges = tel.get("gauges", {})
    counters = tel.get("counters", {})

    st = hists.get("wsp/staleness")
    if st:
        d = gauges.get("wsp/D")
        bound = "" if d is None else (
            f"  bound D={d:g} -> {'OK' if st['max'] <= d else 'VIOLATED'}")
        lines.append(f"wsp staleness: n={st['count']} max={st['max']:g} "
                     f"mean={st['sum'] / max(1, st['count']):.2f}{bound}")
        lines.append(f"  hist: {_hist_line(st)}")
        if d is not None and st["max"] > d:
            raise ValueError(
                f"staleness audit failed: measured max {st['max']:g} exceeds "
                f"the Plan's D={d:g}")

    links = sorted(k.split("/", 2)[1] for k in gauges
                   if k.startswith("link/") and k.endswith("/bytes"))
    for ln in links:
        b = gauges.get(f"link/{ln}/bytes", 0.0)
        s = gauges.get(f"link/{ln}/modeled_s", 0.0)
        util = min(1.0, s / wall)
        lines.append(f"link {ln:<18s} bytes={b / 1e6:8.2f}MB "
                     f"modeled={_fmt_s(s):>9s} util={util:5.1%}")

    faults = {k.split("/", 1)[1]: v for k, v in sorted(counters.items())
              if k.startswith("fault/")}
    if faults:
        lines.append("faults: " + " ".join(f"{k}={v:g}"
                                           for k, v in faults.items()))
        recovered = (faults.get("rejoins", 0) >= faults.get("evictions", 0)
                     and not faults.get("gate_timeouts", 0))
        lines.append(f"  recovery: "
                     f"{'complete' if recovered else 'partial/degraded'} "
                     f"(evictions={faults.get('evictions', 0):g} "
                     f"rejoins={faults.get('rejoins', 0):g} "
                     f"gate_timeouts={faults.get('gate_timeouts', 0):g})")

    ttft = hists.get("serve/ttft_s")
    if ttft:
        lines.append(f"serve ttft: n={ttft['count']} "
                     f"mean={_fmt_s(ttft['sum'] / max(1, ttft['count']))} "
                     f"max={_fmt_s(ttft['max'])}")
    hit = gauges.get("serve/prefix_hit_rate")
    if hit is not None:
        lines.append(f"serve memory: prefix_hit_rate={hit:.1%} "
                     f"evictions={counters.get('serve/evictions', 0):g} "
                     f"preemptions="
                     f"{counters.get('serve/preemptions', 0):g}")
    disp = counters.get("serve/router_dispatches")
    if disp:
        lines.append(f"serve router: dispatches={disp:g} "
                     f"affinity_hits="
                     f"{counters.get('serve/router_affinity_hits', 0):g} "
                     f"rebalances="
                     f"{counters.get('serve/router_rebalances', 0):g} "
                     f"queue_depth_peak="
                     f"{gauges.get('serve/router_queue_depth', 0):g} "
                     f"replica_downs="
                     f"{counters.get('fault/replica_downs', 0):g}")
    wt = hists.get("train/wait_s")
    if wt:
        lines.append(f"gate waits: n={wt['count']} "
                     f"total={_fmt_s(wt['sum'])} max={_fmt_s(wt['max'])}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome trace JSON written by --trace / "
                                  "Tracer.export")
    a = ap.parse_args(argv)
    try:
        doc = load(a.trace)
        for line in summarize(doc):
            print(line)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
