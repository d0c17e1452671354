"""Heartbeat-driven fleet supervision: eviction + elastic rejoin (a copy of
repro.faults.supervisor).

The supervisor watches the threaded WSP fleet from the Engine's
supervision loop. A worker's *heartbeat is its WSP clock* — the number of
waves it has landed — so failure detection runs in the protocol's own
currency rather than wall time:

  dead    the worker thread exited without deregistering (an injected
          WorkerCrash models a node that vanishes mid-run and cannot say
          goodbye). Evicted as soon as detected: a dead worker's clock
          pins the global minimum forever, so every survivor would
          otherwise stall at the staleness gate within D waves.
  stalled the worker is alive but its clock lags the fleet max by
          >= evict_lag waves and has not advanced for stall_grace_s (the
          grace only debounces merely-slow workers). With evict_lag <= D
          the lag threshold is reached *before* survivors deadlock at the
          gate — the whole point of detecting in clock units.

Eviction deregisters the worker from the WSP clock (its clock leaves the
global min — the paper's proof is parameterized by the live worker count,
so survivors keep training at bounded staleness) and flags the thread to
exit at its next gate. An in-flight async push from an evicted worker may
still land: the ParameterServer applies the delta (a stale-but-sound
gradient) but never advances the clock of a deregistered worker
(`late_pushes`), so eviction can never push a survivor past its D window.

Rejoin spawns a successor worker (`vw{i}r`, `vw{i}rr`, ...) once the
policy's trigger fires — the global clock advancing rejoin_after_waves
past the eviction point (deterministic), or rejoin_delay_s host seconds —
up to rejoin_max times per worker. The successor registers at the current
global clock and pulls w_global, which is exactly the PS state an atomic
checkpoint (ParameterServer.checkpoint_state) would hand a re-provisioned
node; its traffic is aliased onto the failed worker's topology endpoint.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.faults.plan import FaultPolicy
from repro_torch.obs import NULL_TRACER


@dataclass
class _WorkerWatch:
    clock: int = 0
    last_advance: float = field(default_factory=time.monotonic)


@dataclass
class Eviction:
    wid: str
    at_clock: int               # global clock when evicted
    reason: str                 # 'dead' | 'stalled' | 'crashed'
    t: float = field(default_factory=time.monotonic)
    rejoined: int = 0


class FleetSupervisor:
    """Polled from the Engine's supervision loop; owns evict/rejoin state.

    `spawn(index, wid)` builds, registers and starts a successor worker
    (the Engine provides it so the supervisor stays runtime-agnostic)."""

    def __init__(self, ps, workers: dict, policy: FaultPolicy, *,
                 spawn: Optional[Callable[[int, str], object]] = None,
                 topology=None, tracer=None):
        self.ps = ps
        self.workers = workers
        self.policy = policy
        self.spawn = spawn
        self.topology = topology
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._watch: dict[str, _WorkerWatch] = {}
        self.evictions: list[Eviction] = []
        self.rejoins: list[str] = []
        self._handled: set[str] = set()

    # ------------------------------------------------------------------
    @staticmethod
    def base_index(wid: str) -> int:
        """'vw2rr' -> 2: the original fleet index a successor maps onto."""
        return int(wid[2:].rstrip("r"))

    def _evict(self, wid: str, worker, reason: str) -> None:
        self._handled.add(wid)
        ev = Eviction(wid, at_clock=self.ps.clock.global_clock(),
                      reason=reason)
        self.evictions.append(ev)
        if reason != "crashed":       # crashed = already deregistered itself
            if worker is not None:
                worker.evict()
            self.ps.deregister(wid)
        self.tracer.instant("supervisor", "evict", wid=wid, reason=reason,
                            at_clock=ev.at_clock)
        self.tracer.metrics.counter_inc("fault/evictions")

    def _try_rejoin(self, ev: Eviction) -> None:
        pol = self.policy
        if self.spawn is None or not pol.rejoins \
                or ev.rejoined >= pol.rejoin_max:
            return
        due = False
        if pol.rejoin_after_waves is not None:
            due |= (self.ps.clock.global_clock()
                    >= ev.at_clock + pol.rejoin_after_waves)
        if pol.rejoin_delay_s is not None:
            due |= time.monotonic() - ev.t >= pol.rejoin_delay_s
        if not due:
            return
        ev.rejoined += 1
        new_wid = ev.wid + "r"
        if new_wid in self.workers:     # successor also died; chain the name
            while new_wid in self.workers:
                new_wid += "r"
        i = self.base_index(ev.wid)
        if self.topology is not None and f"vw{i}" in self.topology.pod_of:
            # the successor lives on the failed worker's node as far as
            # the network model is concerned — its traffic lands on the
            # same links
            self.topology.add_alias(new_wid, f"vw{i}")
        w = self.spawn(i, new_wid)
        self.rejoins.append(new_wid)
        self.tracer.instant("supervisor", "rejoin", wid=new_wid,
                            for_wid=ev.wid,
                            at_clock=self.ps.clock.global_clock())
        self.tracer.metrics.counter_inc("fault/rejoins")
        return w

    def pending_rejoin(self) -> bool:
        """True while some eviction still owes a rejoin that is guaranteed
        to eventually fire — the Engine's supervision loop keeps running
        for these even after every thread has exited. A wave-triggered
        rejoin whose clock condition cannot advance anymore only counts
        when it is already due (it would otherwise spin forever)."""
        pol = self.policy
        if self.spawn is None or not pol.rejoins:
            return False
        for ev in self.evictions:
            if ev.rejoined >= pol.rejoin_max:
                continue
            if pol.rejoin_delay_s is not None:
                return True
            if pol.rejoin_after_waves is not None and \
                    self.ps.clock.global_clock() \
                    >= ev.at_clock + pol.rejoin_after_waves:
                return True
        return False

    # ------------------------------------------------------------------
    def poll(self) -> None:
        """One supervision pass: heartbeat bookkeeping, eviction of dead /
        stalled workers, rejoin of the evicted."""
        pol = self.policy
        clocks = dict(self.ps.clock.state.clocks)
        fleet_max = max(clocks.values()) if clocks else 0
        now = time.monotonic()
        for wid, worker in list(self.workers.items()):
            if wid in self._handled:
                continue
            registered = wid in clocks
            if not registered:
                if worker.failed and not worker.is_alive():
                    # deregistered itself on the way down (graceful crash:
                    # fail_at / transport exhaustion) — eligible for rejoin
                    self._evict(wid, worker, "crashed")
                continue
            watch = self._watch.setdefault(wid, _WorkerWatch(clocks[wid]))
            if clocks[wid] != watch.clock:
                watch.clock, watch.last_advance = clocks[wid], now
            if pol.evict_lag <= 0:
                continue
            if getattr(worker, "done", False):
                # finished its waves; its clock legitimately stops — not a
                # failure, never evict
                continue
            if not worker.is_alive():
                # dead without goodbye: its clock pins the global minimum
                # forever — evict unconditionally
                self._evict(wid, worker, "dead")
                continue
            lag = fleet_max - clocks[wid]
            # clock 0 = first wave still running, which includes the warm-up
            # — debounce with the (much larger) startup grace so a healthy
            # fleet mid-warm-up is never evicted
            grace = pol.startup_grace_s if clocks[wid] == 0 \
                else pol.stall_grace_s
            if lag >= pol.evict_lag and \
                    now - watch.last_advance >= grace:
                self._evict(wid, worker, "stalled")
        for ev in self.evictions:
            self._try_rejoin(ev)
