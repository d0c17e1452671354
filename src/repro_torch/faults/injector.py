"""Runtime fault injection: the FaultPlan compiled into O(1) lookups (a copy
of repro.faults.injector; its verdict sequences equal the JAX package's).

One `FaultInjector` is built per Engine run and threaded through the three
seams: the transport (per-attempt message verdicts), the
parameter server (push-apply stalls) and the scheduler (slot faults). All
decisions key on logical indices the injector tracks itself — per-path
attempt counters, push counts, decode steps — so two runs of the same
Plan inject identical fault sequences.

Message-loss draws are stateless: attempt `a` on path (src, dst) hashes
(plan.seed, crc32(path), a) into a fresh Generator, so a retry (a new
attempt index) gets an independent draw and the sequence never depends on
thread interleaving across paths.
"""
from __future__ import annotations

import threading
import zlib
from collections import defaultdict

import numpy as np

from repro_torch.faults.plan import (FaultPlan, LinkFault, PSStall, SlotFault,
                               WorkerCrash, WorkerSlowdown)


class FaultInjector:
    def __init__(self, plan: FaultPlan | None, *, time_scale: float = 1.0):
        self.plan = plan if plan is not None else FaultPlan()
        self.time_scale = float(time_scale)
        self._lock = threading.Lock()
        self._msg_idx: dict[tuple, int] = defaultdict(int)
        # per-kind lookups
        self._link: dict[tuple, list[LinkFault]] = defaultdict(list)
        self._crash: dict[int, int] = {}
        self._slow: dict[int, WorkerSlowdown] = {}
        self._ps_stall: dict[int, float] = {}
        self._slot: dict[int, list[int]] = defaultdict(list)
        for ev in self.plan.events:
            if isinstance(ev, LinkFault):
                self._link[(ev.src, ev.dst)].append(ev)
            elif isinstance(ev, WorkerCrash):
                # earliest crash wins if several name the same worker
                w = self._crash.get(ev.vw)
                self._crash[ev.vw] = ev.wave if w is None else min(w, ev.wave)
            elif isinstance(ev, WorkerSlowdown):
                self._slow.setdefault(ev.vw, ev)
            elif isinstance(ev, PSStall):
                self._ps_stall[ev.at_push] = max(
                    self._ps_stall.get(ev.at_push, 0.0), ev.seconds)
            elif isinstance(ev, SlotFault):
                self._slot[ev.step].append(ev.slot)

    # ---- transport seam ---------------------------------------------------
    def _attempt_verdict(self, path: tuple, a: int) -> tuple[bool, float]:
        """(ok, cost_factor) for attempt index `a` on `path`."""
        ok, factor = True, 1.0
        for ev in self._link.get(path, ()):
            if not ev.start_msg <= a < ev.start_msg + ev.n_msgs:
                continue
            if ev.kind == "outage":
                ok = False
            elif ev.kind == "degrade":
                factor *= ev.factor
            elif ev.kind == "loss":
                key = (self.plan.seed,
                       zlib.crc32(f"{path[0]}->{path[1]}".encode()), a)
                if np.random.default_rng(key).random() < ev.p:
                    ok = False
        return ok, factor

    def message_attempts(self, src: str, dst: str,
                         max_attempts: int) -> list[tuple[bool, float]]:
        """Consume up to `max_attempts` attempt indices on the (src, dst)
        path and return their (ok, cost_factor) verdicts, stopping after
        the first success. The empty-plan fast path returns a single clean
        attempt without touching the counter."""
        path = (src, dst)
        if path not in self._link:
            return [(True, 1.0)]
        out = []
        with self._lock:        # one message's attempts stay contiguous
            for _ in range(max_attempts):
                a = self._msg_idx[path]
                self._msg_idx[path] += 1
                v = self._attempt_verdict(path, a)
                out.append(v)
                if v[0]:
                    break
        return out

    # ---- worker seam ------------------------------------------------------
    def crash_wave(self, vw: int) -> int | None:
        return self._crash.get(vw)

    def slowdown_extra(self, vw: int, wave: int) -> float:
        """Extra host seconds of compute for `vw` at `wave` (modeled
        slowdown scaled like every other simulated delay)."""
        ev = self._slow.get(vw)
        if ev is None or wave < ev.wave:
            return 0.0
        return ev.extra_s * self.time_scale

    # ---- parameter-server seam -------------------------------------------
    def ps_stall_sleep(self, push_idx: int) -> float:
        """Host seconds to sleep before applying push number `push_idx`
        (modeled stall scaled like every other simulated delay)."""
        return self._ps_stall.get(push_idx, 0.0) * self.time_scale

    # ---- scheduler seam ---------------------------------------------------
    def slot_faults(self, step: int) -> list[int]:
        return self._slot.get(step, [])

    @property
    def empty(self) -> bool:
        return not self.plan.events
