"""Simulated transport: per-link delay, fault injection and byte accounting
(a copy of repro.dist.transport).

The threaded WSP runtime models heterogeneous *compute* with per-VW speed
factors; this transport adds the *network* side. Every ParameterServer
push/pull routes through Transport.send(src, dst, nbytes), which

  - prices the message on the topology's link (alpha + bytes/beta),
  - sleeps for that time (scaled by time_scale so experiments stay fast),
  - serializes concurrent messages on the same link (a per-link lock — the
    simple contention model: a link is a shared resource, transfers queue),
  - accounts bytes and modeled seconds per link for the training report.

send_async() starts a transfer without blocking the caller: it accounts the
message immediately and returns an AsyncSend handle whose wait() performs the
(scaled, link-serialized) delay. A background pusher calling wait() while the
issuing thread keeps computing is how the runtime charges max(compute, comm)
per wave instead of the sum.

Fault injection (repro_torch.faults): when built with an injector, every
message consults it per *attempt*. A dropped attempt costs the policy's modeled
per-message timeout, then the transport retries under capped exponential
backoff up to `max_retries`; a degraded attempt pays a multiplied link
cost. Drops and retries are accounted per link (`stats()['drops_by_link'
/'retries_by_link']`), and a message whose retry budget is exhausted
raises the typed `TransportError` from wait() — the ParameterServer turns
that into a PushTimeout on the push path. The verdicts come from the
seeded FaultPlan keyed on per-path message counters, so the fault
sequence — and therefore every drop/retry counter — is deterministic
across runs.

NullTransport is the zero-latency default: pure accounting, no waiting
(faults still inject if an injector is attached; only the sleeps vanish).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict


class AsyncSend:
    """Handle for an in-flight transfer.

    `seconds` is the modeled (unscaled) link time — including retries and
    failed-attempt timeouts — known at issue time. wait() performs the
    scaled sleep (serialized per link) exactly once and is safe to call
    from any thread; done() reports completion without blocking. A
    transfer that terminally failed raises its TransportError from wait()
    (every waiter sees the same error).
    """

    def __init__(self, seconds: float = 0.0, waiter=None, exc=None):
        self.seconds = float(seconds)
        self._waiter = waiter
        self._exc = exc
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
                    except Exception as e:
                        self._exc = e
                    finally:
                        self._done.set()
        self._done.wait()
        if self._exc is not None:
            raise self._exc
        return self.seconds


class NullTransport:
    """Zero-cost transport: counts bytes (and faults), never sleeps."""

    def __init__(self, *, injector=None, policy=None):
        self.bytes_by_link = defaultdict(int)
        self.seconds_by_link = defaultdict(float)
        self.drops_by_link = defaultdict(int)
        self.retries_by_link = defaultdict(int)
        self.injector = injector
        if policy is None and injector is not None:
            from repro_torch.faults.plan import FaultPolicy
            policy = FaultPolicy()
        self.policy = policy
        self._stats_lock = threading.Lock()

    def _consult(self, src: str, dst: str):
        """(attempts [(ok, cost_factor)], drops, retries, ok) for one
        message; the no-injector fast path is a single clean attempt."""
        if self.injector is None:
            return [(True, 1.0)], 0, 0, True
        att = self.injector.message_attempts(
            src, dst, 1 + self.policy.max_retries)
        ok = att[-1][0]
        retries = len(att) - 1
        drops = retries + (0 if ok else 1)
        return att, drops, retries, ok

    def _account_faults(self, name: str, drops: int, retries: int) -> None:
        if drops or retries:
            with self._stats_lock:
                self.drops_by_link[name] += drops
                self.retries_by_link[name] += retries

    def send_async(self, src: str, dst: str, nbytes: int) -> AsyncSend:
        att, drops, retries, ok = self._consult(src, dst)
        with self._stats_lock:
            self.bytes_by_link["loopback"] += int(nbytes)
        self._account_faults("loopback", drops, retries)
        if not ok:
            from repro_torch.faults.errors import TransportError
            return AsyncSend(0.0, exc=TransportError(
                src, dst, "loopback", len(att), int(nbytes)))
        return AsyncSend(0.0)

    def send(self, src: str, dst: str, nbytes: int) -> float:
        return self.send_async(src, dst, nbytes).wait()

    def stats(self) -> dict:
        return {"bytes_by_link": dict(self.bytes_by_link),
                "seconds_by_link": dict(self.seconds_by_link),
                "drops_by_link": dict(self.drops_by_link),
                "retries_by_link": dict(self.retries_by_link),
                "drops": sum(self.drops_by_link.values()),
                "retries": sum(self.retries_by_link.values()),
                "modeled_seconds": sum(self.seconds_by_link.values())}


class SimulatedTransport(NullTransport):
    def __init__(self, topology, *, time_scale: float = 1.0,
                 max_sleep_per_msg: float = 0.25, tracer=None,
                 injector=None, policy=None):
        super().__init__(injector=injector, policy=policy)
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
        scaled delay under the link lock (contention) when called. The
        whole retry schedule (verdicts, backoffs, degradation factors) is
        fixed at issue time from the deterministic per-path counters."""
        nbytes = int(nbytes)
        cost = self.topology.p2p_cost(src, dst, nbytes)
        link = self.topology.link(src, dst) if cost > 0 else None
        name = link.name if link is not None else "local"
        att, drops, retries, ok = self._consult(src, dst)
        # modeled seconds: each failed attempt pays the message timeout
        # plus its capped exponential backoff; the final attempt (if any
        # succeeded) pays the link cost times its degradation factor
        modeled = cost * att[-1][1] if ok else 0.0
        if drops or retries:
            pol = self.policy
            for i in range(retries + (0 if ok else 1)):
                modeled += pol.msg_timeout_s + min(
                    pol.backoff_base_s * (2 ** i), pol.backoff_cap_s)
        with self._stats_lock:
            self.bytes_by_link[name] += nbytes
            self.seconds_by_link[name] += modeled
        self._account_faults(name, drops, retries)
        fail_exc = None
        if not ok:
            from repro_torch.faults.errors import TransportError
            fail_exc = TransportError(src, dst, name, len(att), nbytes)
        if modeled <= 0 and fail_exc is None:
            return AsyncSend(0.0)
        delay = min(modeled * self.time_scale, self.max_sleep_per_msg)
        tracer = self.tracer

        def waiter():
            # holding the link lock while sleeping serializes transfers that
            # share the link — concurrent pushers contend for bandwidth
            # (the span covers queueing *and* the wire, so per-link tracks
            # show contention as back-to-back transfers)
            with tracer.span(f"link:{name}", "send", src=src, dst=dst,
                             bytes=nbytes, modeled_s=modeled,
                             retries=retries):
                if drops:
                    tracer.instant(f"link:{name}", "drop", src=src, dst=dst,
                                   drops=drops, retries=retries)
                    tracer.metrics.counter_inc("fault/drops", drops)
                    tracer.metrics.counter_inc("fault/retries", retries)
                with self._lock_for(name):
                    if delay > 0:
                        time.sleep(delay)
            if fail_exc is not None:
                raise fail_exc

        return AsyncSend(modeled, waiter, None)
