"""A virtual worker: the paper's group of k GPUs running PMP, driven as a
thread against the parameter server with WSP gating (the port of
repro.runtime.virtual_worker).

The wave step is any callable (build_local_wave_step on the worker's
device); the WSP protocol is the JAX package's. Heterogeneity is simulated
with per-VW speed factors / straggle schedules. The worker's params,
optimizer state and deltas live on its device; once a wave its deltas go
to the host in one flat copy (runtime.staging) and every pull_every waves
w_global comes back the same way. `metrics` keeps each wave's copy and
parameter-server times.

With async_push=True the VW overlaps its wave-aggregated push with the next
wave's compute (paper Section 5): the host copy of the delta is handed to a
per-worker outbox thread which pays the transport delay, applies the
update, and advances the WSP clock when the push *lands*. The VW starts the
next wave on its locally-updated weights, gating each wave at its logical
clock (at_clock) so overlap never buys extra staleness, and waits for the
in-flight push before the next push (ordering) or any pull (a pull must see
the worker's own landed wave).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch import obs
from repro_torch.obs import NULL_TRACER
from repro_torch.obs.metrics import INT_BOUNDS, SECONDS_BOUNDS
from repro_torch.runtime.staging import HostStaging, add_, device_tree


@dataclass
class VWMetrics:
    losses: list = field(default_factory=list)
    wave_times: list = field(default_factory=list)
    wall_clock: list = field(default_factory=list)
    waves: int = 0
    overlap_seconds: float = 0.0    # in-flight push time hidden under compute
    push_wait_seconds: float = 0.0  # time blocked on an in-flight push
    gate_timeouts: int = 0          # staleness gates that timed out
    # per wave, the push as the worker sees it (the deltas' D2H + compress
    # + apply when blocking; D2H + enqueue when async), and per pull the PS
    # snapshot + H2D
    push_s: list = field(default_factory=list)
    pull_s: list = field(default_factory=list)


class _PushHandle:
    __slots__ = ("event", "clock", "enqueued_at", "landed_at", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.clock = None
        self.enqueued_at = time.monotonic()
        self.landed_at = None
        self.exc = None


class _Outbox(threading.Thread):
    """Per-worker background pusher: drains queued deltas into the PS in
    FIFO order, paying the transport delay off the worker's critical path."""

    def __init__(self, wid: str, ps, tracer=NULL_TRACER):
        super().__init__(daemon=True, name=f"{wid}-outbox")
        self.wid, self.ps, self.tracer = wid, ps, tracer
        self._q: queue.Queue = queue.Queue()

    def submit(self, deltas, wave: int) -> _PushHandle:
        h = _PushHandle()
        self._q.put((deltas, h, wave))
        return h

    def close(self):
        self._q.put(None)

    def run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            deltas, h, wave = item
            # the push span covers the in-flight segment: transport delay +
            # apply + clock advance, on the worker's outbox track
            with self.tracer.span(f"{self.wid}/outbox", "push", wave=wave):
                try:
                    h.clock = self.ps.push_wave(self.wid, deltas, wave=wave)
                except Exception as e:      # surfaced at the next await
                    h.exc = e
            h.landed_at = time.monotonic()
            h.event.set()


class VirtualWorker(threading.Thread):
    def __init__(self, wid: str, ps, wave_step: Callable, loader,
                 opt_init: Callable, *, device, max_waves: int,
                 pull_every: int = 1, slowdown: float = 0.0,
                 straggle_fn: Optional[Callable[[int], float]] = None,
                 stop_event: Optional[threading.Event] = None,
                 fail_at_wave: Optional[int] = None,
                 async_push: bool = False,
                 tracer=None, D: Optional[int] = None,
                 injector=None, vw_index: Optional[int] = None,
                 crash_at: Optional[int] = None,
                 gate_timeout_s: float = 120.0):
        """opt_init(params) builds the optimizer state from the worker's
        device params once they are pulled."""
        super().__init__(daemon=True, name=wid)
        self.wid, self.ps, self.wave_step = wid, ps, wave_step
        self.loader, self.opt_init = loader, opt_init
        self.device = device
        self.opt_state = None
        self.max_waves, self.pull_every = max_waves, pull_every
        self.slowdown, self.straggle_fn = slowdown, straggle_fn
        self.stop_event = stop_event or threading.Event()
        # fail_at_wave: a graceful failure that says goodbye (deregisters);
        # crash_at kills the thread WITHOUT deregistering (an injected
        # WorkerCrash — the supervisor must notice and evict). injector +
        # vw_index drive slowdown-onset consults.
        self.fail_at_wave = fail_at_wave
        self.injector = injector
        self.vw_index = vw_index
        self.crash_at = crash_at
        self.async_push = async_push
        self.gate_timeout_s = gate_timeout_s
        # observability: D is the Plan's staleness bound (audited per wave)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.audit_D = D
        self.metrics = VWMetrics()
        self.failed = False
        self.done = False               # completed its waves normally
        self.error = None               # the FaultError that took us down
        self.crashed = False            # died without deregistering
        self.evicted = False            # supervisor pulled us from the clock
        self.params = None
        self.staging: Optional[HostStaging] = None
        self._outbox: Optional[_Outbox] = None
        self._inflight: Optional[_PushHandle] = None

    def evict(self):
        """Called by the FleetSupervisor (before it deregisters us): the
        worker exits cleanly at its next gate instead of training on."""
        self.evicted = True

    def _release(self):
        """Drop a worker's device state (params, optimizer moments, the
        staging buffers) when it leaves without finishing — crashed, evicted
        or failed — so a successor at full width does not sit beside a dead
        worker's tensors. A worker that finished keeps its state: the
        Engine's report and its callers read it."""
        self.params = self.opt_state = self.staging = None

    def _await_inflight(self, timeout: float = 120.0, compute_span=None):
        """Block until the in-flight push (if any) has landed. Only the
        flight time inside `compute_span` (the [start, end) wall interval
        of the wave's work that ran while the push was in flight) is
        credited as overlap."""
        h, self._inflight = self._inflight, None
        if h is None:
            return
        t_wait = time.monotonic()
        if not h.event.wait(timeout):
            raise TimeoutError(f"{self.wid}: async push did not land")
        if h.exc is not None:
            raise h.exc
        now = time.monotonic()
        self.metrics.push_wait_seconds += now - t_wait
        if compute_span is not None:
            c0, c1 = compute_span
            self.metrics.overlap_seconds += max(
                0.0, min(h.landed_at, c1) - max(h.enqueued_at, c0))

    def _pull(self, wave: int):
        """w_global, for wave `wave` to start from, into the device params
        (allocated at the first pull)."""
        t0 = time.monotonic()
        host = self.ps.pull(self.wid, wave=wave)
        if self.params is None:
            self.params = device_tree(host, self.device)
            self.staging = HostStaging(self.params, self.device)
        else:
            with obs.span("h2d"):
                self.staging.to_device(host, self.params)
        self.metrics.pull_s.append(time.monotonic() - t0)

    def run(self):
        # each worker thread issues its device work on its own stream, so
        # two workers sharing a card overlap and a worker's copies wait
        # for its own kernels only
        dev = torch.device(self.device)
        ctx = torch.cuda.stream(torch.cuda.Stream(dev)) \
            if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            self._run()

    def _run(self):
        t_start = time.monotonic()
        tr = self.tracer
        self.ps.register(self.wid)
        wave = self.ps.clock.local_clock(self.wid)
        self._pull(wave)
        self.opt_state = self.opt_init(self.params)
        if self.async_push:
            self._outbox = _Outbox(self.wid, self.ps, tracer=tr)
            self._outbox.start()
        try:
            while wave < self.max_waves and not self.stop_event.is_set():
                if self.fail_at_wave is not None and wave == self.fail_at_wave:
                    self.failed = True
                    self._await_inflight()
                    self.ps.deregister(self.wid)      # simulated node failure
                    return
                if self.crash_at is not None and wave == self.crash_at:
                    # injected WorkerCrash: the node vanishes — no goodbye,
                    # no deregister, and any in-flight push is left to land
                    # (or not) on its own. Detection is the supervisor's job.
                    self.failed = self.crashed = True
                    tr.instant(self.wid, "crash", wave=wave)
                    tr.metrics.counter_inc("fault/crashes")
                    return
                # gate at the logical clock: `wave` counts enqueued pushes,
                # so the staleness predicate matches the blocking runtime
                # even while a push is still in flight
                tg = tr.now()
                if not self.ps.gate(self.wid, timeout=self.gate_timeout_s,
                                    at_clock=wave):
                    # deregistered while waiting: the supervisor evicted us
                    self.evicted = True
                    tr.instant(self.wid, "evicted_exit", wave=wave)
                    return
                tg1 = tr.now()
                if tg1 - tg > 1e-4:     # only waits, not instant passes
                    tr.add_span(self.wid, "gate_wait", tg, tg1, wave=wave)
                tr.metrics.observe("train/wait_s", tg1 - tg,
                                   bounds=SECONDS_BOUNDS)
                # staleness this wave runs at: my clock minus the slowest
                # worker's. The gate just guaranteed stale <= D and the
                # global clock only grows, so any sample > D is a protocol
                # violation — the audit the tests and the smoke enforce.
                stale = wave - self.ps.clock.global_clock()
                tr.metrics.observe("wsp/staleness", float(stale),
                                   bounds=INT_BOUNDS)
                tr.counter(self.wid, "staleness", stale)
                if self.audit_D is not None and stale > self.audit_D:
                    tr.instant(self.wid, "staleness_violation",
                               wave=wave, stale=stale, D=self.audit_D)
                    tr.metrics.counter_inc("wsp/staleness_violations")
                t0 = time.monotonic()
                # core.wave records the wave's parts into the bound scope
                with tr.bind(self.wid, wave=wave), \
                        tr.span(self.wid, "wave", wave=wave):
                    x, y = self.loader.next()
                    deltas, self.opt_state, loss = self.wave_step(
                        self.params, self.opt_state, x, y)
                    loss = float(loss)
                    extra = self.slowdown
                    if self.straggle_fn is not None:
                        extra += self.straggle_fn(wave)
                    if self.injector is not None and self.vw_index is not None:
                        extra += self.injector.slowdown_extra(
                            self.vw_index, wave)
                    if extra > 0:
                        time.sleep(extra)
                tp = time.monotonic()
                host = self.staging.to_host(deltas)
                if self._outbox is not None:
                    # pushes land in order: wave w-1 must be applied before
                    # wave w's transfer may complete
                    self._await_inflight(compute_span=(t0, tp))
                    self._inflight = self._outbox.submit(host, wave)
                    tr.instant(self.wid, "push_enqueue", wave=wave)
                    wave += 1
                else:
                    with tr.span(self.wid, "push", wave=wave):
                        wave = self.ps.push_wave(self.wid, host, wave=wave)
                self.metrics.push_s.append(time.monotonic() - tp)
                tr.counter(self.wid, "clock", wave)
                # local weights see their own wave immediately (paper Sec. 4)
                # — unless the pull below replaces them wholesale anyway
                if self.pull_every != 1:
                    add_(self.params, deltas)
                if self.pull_every and wave % self.pull_every == 0:
                    # a pull must include this worker's own landed wave
                    with tr.bind(self.wid, wave=wave), \
                            tr.span(self.wid, "pull", wave=wave):
                        with obs.span("pull_wait"):
                            self._await_inflight()
                        self._pull(wave)
                self.metrics.losses.append(loss)
                self.metrics.wave_times.append(time.monotonic() - t0)
                self.metrics.wall_clock.append(time.monotonic() - t_start)
                self.metrics.waves = wave
            self._await_inflight()
            self.done = True
        except Exception as e:
            from repro_torch.faults.errors import FaultError, GateTimeout
            self.failed = True
            if isinstance(e, FaultError):
                # typed fault: record it, say goodbye, exit — the Engine
                # surfaces it via TrainReport counters / DegradedRunError
                self.error = e
                if isinstance(e, GateTimeout):
                    self.metrics.gate_timeouts += 1
                    tr.instant(self.wid, "gate_timeout", wave=e.wave)
                    tr.metrics.counter_inc("fault/gate_timeouts")
                else:
                    tr.instant(self.wid, "fault_crash", error=repr(e))
                    tr.metrics.counter_inc("fault/crashes")
                self.ps.deregister(self.wid)
                return
            raise
        finally:
            if self._outbox is not None:
                self._outbox.close()
                self._outbox.join(timeout=10.0)
            if not self.done:
                self._release()
