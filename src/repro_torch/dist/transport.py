"""Simulated transport: per-link delay and byte accounting (the port of
repro.dist.transport; its fault injection is ROADMAP Queue 1 item 7).

Every ParameterServer push/pull routes through Transport.send(src, dst,
nbytes), which

  - prices the message on the topology's link (alpha + bytes/beta),
  - sleeps for that time (scaled by time_scale so experiments stay fast),
  - serializes concurrent messages on the same link (a per-link lock — a
    link is a shared resource, transfers queue),
  - accounts bytes and modeled seconds per link for the training report.

send_async() starts a transfer without blocking the caller: it accounts the
message immediately and returns an AsyncSend handle whose wait() performs the
(scaled, link-serialized) delay. A background pusher calling wait() while the
issuing thread keeps computing is how the runtime charges max(compute, comm)
per wave instead of the sum.

NullTransport is the zero-latency default: pure accounting, no waiting.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict


class AsyncSend:
    """Handle for an in-flight transfer.

    `seconds` is the modeled (unscaled) link time, known at issue time.
    wait() performs the scaled sleep (serialized per link) exactly once and
    is safe to call from any thread; done() reports completion without
    blocking.
    """

    def __init__(self, seconds: float = 0.0, waiter=None):
        self.seconds = float(seconds)
        self._waiter = waiter
        self._done = threading.Event()
        self._wait_lock = threading.Lock()
        if waiter is None:
            self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self) -> float:
        if not self._done.is_set():
            with self._wait_lock:                # first waiter pays the delay
                if not self._done.is_set():
                    try:
                        self._waiter()
                    finally:
                        self._done.set()
        self._done.wait()
        return self.seconds


class NullTransport:
    """Zero-cost transport: counts bytes, never sleeps."""

    def __init__(self):
        self.bytes_by_link = defaultdict(int)
        self.seconds_by_link = defaultdict(float)
        self._stats_lock = threading.Lock()

    def send_async(self, src: str, dst: str, nbytes: int) -> AsyncSend:
        with self._stats_lock:
            self.bytes_by_link["loopback"] += int(nbytes)
        return AsyncSend(0.0)

    def send(self, src: str, dst: str, nbytes: int) -> float:
        return self.send_async(src, dst, nbytes).wait()

    def stats(self) -> dict:
        return {"bytes_by_link": dict(self.bytes_by_link),
                "seconds_by_link": dict(self.seconds_by_link),
                "modeled_seconds": sum(self.seconds_by_link.values())}


class SimulatedTransport(NullTransport):
    def __init__(self, topology, *, time_scale: float = 1.0,
                 max_sleep_per_msg: float = 0.25, tracer=None):
        super().__init__()
        self.topology = topology
        self.time_scale = float(time_scale)
        self.max_sleep_per_msg = float(max_sleep_per_msg)
        self._link_locks: dict[str, threading.Lock] = defaultdict(
            threading.Lock)
        self._reg_lock = threading.Lock()
        if tracer is None:
            from repro_torch.obs import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer

    def _lock_for(self, link_name: str) -> threading.Lock:
        with self._reg_lock:
            return self._link_locks[link_name]

    def send_async(self, src: str, dst: str, nbytes: int) -> AsyncSend:
        """Account the message now; the returned handle's wait() pays the
        scaled delay under the link lock (contention) when called."""
        nbytes = int(nbytes)
        modeled = self.topology.p2p_cost(src, dst, nbytes)
        link = self.topology.link(src, dst) if modeled > 0 else None
        name = link.name if link is not None else "local"
        with self._stats_lock:
            self.bytes_by_link[name] += nbytes
            self.seconds_by_link[name] += modeled
        if modeled <= 0:
            return AsyncSend(0.0)
        delay = min(modeled * self.time_scale, self.max_sleep_per_msg)
        tracer = self.tracer

        def waiter():
            # holding the link lock while sleeping serializes transfers that
            # share the link — concurrent pushers contend for bandwidth
            with tracer.span(f"link:{name}", "send", src=src, dst=dst,
                             bytes=nbytes, modeled_s=modeled):
                with self._lock_for(name):
                    if delay > 0:
                        time.sleep(delay)

        return AsyncSend(modeled, waiter)
