"""Metrics: counters, gauges and fixed-bucket histograms.

A MetricsRegistry is the aggregate side of the observability substrate (the
Tracer is the event side): cheap thread-safe accumulation during a run,
snapshotted once at report-assembly time into
`repro_torch.api.report.Telemetry`.

Histograms use fixed upper-edge buckets (`bounds`) plus an overflow bucket,
and additionally track the exact min/max/sum/count — so audits that must be
exact (the WSP staleness bound: measured max <= Plan D) never depend on
bucket resolution, while quantiles resolve to a bucket upper edge.

A registry built with enabled=False is a true no-op: every method returns
immediately without taking the lock or allocating.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

# default bucket edges by metric flavor: small non-negative integers
# (staleness, queue depths) and log-spaced seconds (latencies)
INT_BOUNDS = tuple(range(0, 17))
SECONDS_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Fixed-bucket histogram with exact min/max/sum/count sidecars."""

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] = SECONDS_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        assert self.bounds == tuple(sorted(self.bounds)), "bounds must ascend"
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile: the upper edge of the bucket holding
        the q-th sample (the exact max for the overflow bucket)."""
        if not self.count:
            return None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return self.bounds[i] if i < len(self.bounds) else self.vmax
        return self.vmax

    def snapshot(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax}


def quantile_from_snapshot(snap: dict, q: float) -> Optional[float]:
    """Histogram.quantile over a snapshot() dict — lets report/bench code
    compute p50/p99 from exported telemetry without a live Histogram."""
    if not snap or not snap.get("count"):
        return None
    bounds = snap["bounds"]
    target = q * snap["count"]
    seen = 0
    for i, c in enumerate(snap["counts"]):
        seen += c
        if seen >= target and c:
            return bounds[i] if i < len(bounds) else snap["max"]
    return snap["max"]


class MetricsRegistry:
    """Thread-safe named counters, gauges and histograms."""

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    def counter_inc(self, name: str, v: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + v

    def gauge_set(self, name: str, v: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = float(v)

    def observe(self, name: str, v: float,
                bounds: Sequence[float] = SECONDS_BOUNDS) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(bounds)
            h.observe(v)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def snapshot(self) -> dict:
        """Plain-dict state: {'counters', 'gauges', 'histograms'} — the
        payload Telemetry.from_metrics wraps and the trace export embeds."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": {n: h.snapshot()
                                   for n, h in self._hists.items()}}
