"""Wave Synchronous Parallel (WSP) clock machinery — paper Sections 4-5
(a copy of repro.core.wsp).

Definitions (paper):
  wave           = s_local + 1 = Nm minibatches processed concurrently by a VW
  local clock c  = number of waves a virtual worker has completed
  global clock   = min over VW local clocks
  staleness D    = max allowed clock distance between fastest and slowest VW

Gating rule: a VW about to *start* wave c must use weights that include every
wave aggregate through wave c - D - 1 from ALL virtual workers; equivalently it
blocks while c_global < c - D.

Thread-safe; supports elastic add/remove of virtual workers (a removed VW's
clock simply leaves the min — WSP's proof is parameterized by the live count N).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


class StalenessViolation(AssertionError):
    pass


@dataclass
class WSPClockState:
    """Pure (lock-free) clock logic, separated for property testing."""
    D: int
    clocks: dict[str, int] = field(default_factory=dict)

    def add_worker(self, wid: str, clock: int | None = None):
        # an elastically (re-)joining worker starts at the global clock: it
        # pulls w_global which contains every wave through c_global - 1.
        self.clocks[wid] = self.global_clock() if clock is None else clock

    def remove_worker(self, wid: str):
        # idempotent: eviction (supervisor) and self-deregistration (the
        # worker's own exit path) may race on the same wid
        self.clocks.pop(wid, None)

    def global_clock(self) -> int:
        return min(self.clocks.values()) if self.clocks else 0

    def can_proceed(self, wid: str, at_clock: int | None = None) -> bool:
        """May `wid` start its next wave (local clock c = clocks[wid])?

        `at_clock` evaluates the same gate at a *logical* clock value: an
        async-pushing worker whose wave-c push is still in flight has
        clocks[wid] < c, but must gate wave c+1 as if the push had landed —
        otherwise overlap would silently buy an extra unit of staleness."""
        c = self.clocks[wid] if at_clock is None else at_clock
        return c - self.D <= self.global_clock()

    def complete_wave(self, wid: str) -> int:
        if not self.can_proceed(wid):
            raise StalenessViolation(
                f"{wid} completed a wave it was not allowed to start: "
                f"local={self.clocks[wid]} global={self.global_clock()} "
                f"D={self.D}")
        self.clocks[wid] += 1
        return self.clocks[wid]

    def max_distance(self) -> int:
        if not self.clocks:
            return 0
        return max(self.clocks.values()) - min(self.clocks.values())


class WSPClockServer:
    """Blocking facade used by the threaded runtime."""

    def __init__(self, D: int):
        self.state = WSPClockState(D)
        self._cv = threading.Condition()
        self.wait_seconds: dict[str, float] = {}

    def register(self, wid: str):
        with self._cv:
            self.state.add_worker(wid)
            self.wait_seconds.setdefault(wid, 0.0)
            self._cv.notify_all()

    def deregister(self, wid: str):
        with self._cv:
            self.state.remove_worker(wid)
            self._cv.notify_all()

    def local_clock(self, wid: str) -> int:
        with self._cv:
            return self.state.clocks[wid]

    def global_clock(self) -> int:
        with self._cv:
            return self.state.global_clock()

    def wait_until_allowed(self, wid: str, timeout: float = 120.0,
                           at_clock: int | None = None) -> bool:
        """Block until `wid` may start its next wave. Returns False on timeout
        or if the worker was deregistered while waiting."""
        return self.wait_reason(wid, timeout, at_clock) == "ok"

    def wait_reason(self, wid: str, timeout: float = 120.0,
                    at_clock: int | None = None) -> str:
        """Like wait_until_allowed but disambiguates the failure:
        'ok' | 'timeout' | 'evicted' (deregistered while waiting — the
        supervisor pulled this worker out of the clock). The fault layer
        needs the distinction: a timeout is a GateTimeout error, an
        eviction is an orderly exit."""
        import time
        t0 = time.monotonic()
        reason = "ok"
        with self._cv:
            while wid in self.state.clocks and \
                    not self.state.can_proceed(wid, at_clock):
                remaining = timeout - (time.monotonic() - t0)
                if remaining <= 0:
                    reason = "timeout"
                    break
                self._cv.wait(remaining)
            if reason == "ok" and wid not in self.state.clocks:
                reason = "evicted"
        self.wait_seconds[wid] = self.wait_seconds.get(wid, 0.0) + (
            time.monotonic() - t0)
        return reason

    def complete_wave(self, wid: str) -> int:
        with self._cv:
            c = self.state.complete_wave(wid)
            self._cv.notify_all()
            return c

    def complete_wave_if_registered(self, wid: str) -> int | None:
        """Advance `wid`'s clock iff it is still registered; None if it was
        deregistered (evicted) meanwhile. The async-push landing path uses
        this so a crashed worker's in-flight push can never advance the
        clock of a worker that has already left the fleet — which would
        move the global minimum past what survivors gated against."""
        with self._cv:
            if wid not in self.state.clocks:
                return None
            c = self.state.complete_wave(wid)
            self._cv.notify_all()
            return c
