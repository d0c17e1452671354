"""Typed fault errors (a copy of repro.faults.errors).

Every failure mode the runtime can recover from gets a named exception, so
callers dispatch on type instead of sentinel booleans: the WSP staleness
gate timing out (`GateTimeout`), a push whose transport retries are
exhausted (`PushTimeout`), a message the (simulated) network lost for good
(`TransportError`), and a run that finished with unrecovered failures
(`DegradedRunError` — raised by Engine.fit() unless the Plan's FaultPolicy
opts into degraded completion).

All inherit FaultError, so "any injectable/recoverable failure" is one
except clause; anything else escaping a worker is a programming error and
still propagates loudly.
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for recoverable, fault-subsystem failures."""


class TransportError(FaultError):
    """A message exhausted its retry budget on a (simulated) link."""

    def __init__(self, src: str, dst: str, link: str, attempts: int,
                 nbytes: int):
        self.src, self.dst, self.link = src, dst, link
        self.attempts, self.nbytes = attempts, nbytes
        super().__init__(
            f"{src}->{dst} ({link}): message of {nbytes} bytes lost after "
            f"{attempts} attempts (retry budget exhausted)")


class PushTimeout(FaultError):
    """A wave push never landed: its wire transfer failed terminally."""

    def __init__(self, wid: str, cause: Exception):
        self.wid, self.cause = wid, cause
        super().__init__(f"{wid}: wave push did not land: {cause}")


class GateTimeout(FaultError):
    """The WSP staleness gate never opened within the timeout — some other
    virtual worker stopped advancing the global clock."""

    def __init__(self, wid: str, wave: int, waited_s: float):
        self.wid, self.wave, self.waited_s = wid, wave, waited_s
        super().__init__(
            f"{wid}: staleness gate for wave {wave} never opened within "
            f"{waited_s:.1f}s — a peer stopped advancing the global clock "
            f"(crashed or stalled worker; enable FaultPolicy eviction to "
            f"recover survivors)")


class DegradedRunError(FaultError):
    """fit() completed with unrecovered failures (gate timeouts, dead
    workers with no successful rejoin). Carries the TrainReport so the
    partial result is inspectable."""

    def __init__(self, msg: str, report=None):
        self.report = report
        super().__init__(msg)
