"""Typed fault errors (the port of repro.faults.errors, for the failures the
runtime can hit without an injector).

The WSP staleness gate timing out raises `GateTimeout`; a run that finished
with unrecovered failures raises `DegradedRunError` from Engine.fit(). Both
inherit FaultError, so "any recoverable failure" is one except clause;
anything else escaping a worker is a programming error and still propagates
loudly.
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for recoverable, fault-subsystem failures."""


class GateTimeout(FaultError):
    """The WSP staleness gate never opened within the timeout — some other
    virtual worker stopped advancing the global clock."""

    def __init__(self, wid: str, wave: int, waited_s: float):
        self.wid, self.wave, self.waited_s = wid, wave, waited_s
        super().__init__(
            f"{wid}: staleness gate for wave {wave} never opened within "
            f"{waited_s:.1f}s — a peer stopped advancing the global clock "
            f"(crashed or stalled worker)")


class DegradedRunError(FaultError):
    """fit() completed with unrecovered failures (gate timeouts, dead
    workers with no successful rejoin). Carries the TrainReport so the
    partial result is inspectable."""

    def __init__(self, msg: str, report=None):
        self.report = report
        super().__init__(msg)
