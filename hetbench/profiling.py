"""The device's side of a traced slice, from torch.profiler (a frozen
copy of the arithmetic of the port's chip_smoke.profile_run): device busy
time as the union of kernel and copy intervals, idle share, time by kernel
name, and the longest idle gaps named by what the host was doing."""
from __future__ import annotations

import time


class Slice:
    """Profiles the device from start() to stop(); `phases` are host
    intervals (name, t0, t1) on time.monotonic that name the idle gaps."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        # the CPU build (the tests) records host ops only: no device time
        self.prof = profile(activities=[ProfilerActivity.CUDA]
                            if torch.cuda.is_available()
                            else [ProfilerActivity.CPU])
        self.prof.start()
        # the slice opens once the profiler runs (starting it takes seconds)
        self.t0 = time.monotonic()

    def stop(self):
        """Closes the slice as the device drains, before the profiler
        collects its trace (which takes seconds, and is no part of it)."""
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop()

    def reduce(self, phases=(), outside="host, outside the traced calls"
               ) -> dict:
        """{busy_s, window_s, by_name {name: seconds}, device_ops, idle_gaps}
        (busy_s None when the profiler recorded no device event)."""
        from torch.autograd import DeviceType
        iv, by_name = [], {}
        for e in self.prof.events():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            iv.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        # the trace's clock has a base of its own: its first device event
        # is taken to start as the slice does
        base = min(a for a, _ in iv) if iv else 0.0
        iv = [(a - base, b - base) for a, b in iv]
        window = self.t1 - self.t0
        out = {"window_s": window, "by_name": by_name, "busy_s": None,
               "device_ops": [], "idle_gaps": []}
        self.prof = None
        if not iv:
            return out
        iv.sort()
        busy, gaps, end = 0.0, [], 0.0
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if window > end:
            gaps.append((end, window))
        out["busy_s"] = busy
        out["device_ops"] = [[n[:120], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        named = []
        for a, b in gaps:
            mid = self.t0 + (a + b) / 2
            owner = [(p1 - p0, n) for n, p0, p1 in phases if p0 <= mid < p1]
            named.append((b - a, min(owner)[1] if owner else outside))
        named.sort(reverse=True)
        out["idle_gaps"] = [[n, s] for s, n in named[:10]]
        return out


def kernel_seconds(by_name: dict, kernels) -> float:
    """Device seconds of the kernels of these function names (matched as
    `::name<` or `::name(` in the demangled names)."""
    return sum(s for n, s in by_name.items()
               if any(f"::{k}<" in n or f"::{k}(" in n for k in kernels))
