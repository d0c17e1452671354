"""Deterministic, seeded fault scenarios (a copy of repro.faults.plan:
numpy draws seeded the same way, so a seed gives the JAX package's events).

A `FaultPlan` is a frozen tuple of typed fault events, each anchored to a
*logical* index — a worker's wave number, a directed link's message
counter, the PS's push count, the scheduler's decode step — never to wall
clock. Two runs of the same Plan therefore inject byte-identical fault
sequences regardless of host timing, which is what makes the chaos suite's
determinism assertions possible.

Events:

  LinkFault       outage / degradation / probabilistic loss window on the
                  directed (src, dst) path, in units of that path's message
                  counter. An outage fails `n_msgs` consecutive *attempts*
                  (retries re-enter the window until it expires), degrade
                  multiplies the modeled cost, loss drops each attempt with
                  probability p (seeded per path — deterministic).
  WorkerCrash     the virtual worker dies at the start of wave `wave`
                  WITHOUT deregistering (a dead node cannot say goodbye) —
                  detection and eviction are the supervisor's job.
  WorkerSlowdown  from wave `wave` on, the worker takes `extra_s` longer
                  per wave (slowdown onset — the flapping/whimpy case).
  PSStall         the parameter server sleeps `seconds` before applying
                  push number `at_push` (a stalled PS shard).
  SlotFault       serving: the decode-batch slot `slot` faults at decode
                  step `step` (its transient per-slot state is lost; the
                  Scheduler quarantines the slot and recovers the request).
  ReplicaDown     serving: replica `replica` of a data-parallel serve
                  fleet (partition.data > 1) dies at *its own* decode step
                  `step`; the Router re-dispatches its unfinished requests
                  onto the survivors (requeue semantics — replay from the
                  prompt, bit-identical streams).

`FaultPolicy` holds the recovery knobs: transport retry/backoff budgets,
heartbeat-driven eviction and rejoin of workers, degraded-completion
opt-in, and the serve-side retry budget / load shedding. It lives on the
Plan next to the FaultPlan (`Plan.faults` / `Plan.fault_policy`), so a
scenario's failures and its recovery posture are validated together.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LinkFault:
    src: str                    # message source endpoint ('vw0', 'ps', ...)
    dst: str                    # destination endpoint
    start_msg: int = 0          # first affected attempt index on this path
    n_msgs: int = 1             # window length, in attempts
    kind: str = "outage"        # 'outage' | 'degrade' | 'loss'
    factor: float = 10.0        # degrade: modeled-cost multiplier
    p: float = 0.5              # loss: per-attempt drop probability

    def validate(self) -> None:
        if self.kind not in ("outage", "degrade", "loss"):
            raise ValueError(f"unknown LinkFault kind {self.kind!r}; "
                             f"expected outage | degrade | loss")
        if self.start_msg < 0 or self.n_msgs < 1:
            raise ValueError(f"LinkFault window [{self.start_msg}, "
                             f"+{self.n_msgs}) must be non-negative and "
                             f"non-empty")
        if self.kind == "degrade" and self.factor <= 0:
            raise ValueError(f"degrade factor must be > 0, got {self.factor}")
        if self.kind == "loss" and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"loss probability must be in [0, 1], "
                             f"got {self.p}")


@dataclass(frozen=True)
class WorkerCrash:
    vw: int                     # virtual worker index
    wave: int                   # dies at the start of this wave

    def validate(self) -> None:
        if self.vw < 0 or self.wave < 0:
            raise ValueError(f"WorkerCrash(vw={self.vw}, wave={self.wave}) "
                             f"must be non-negative")


@dataclass(frozen=True)
class WorkerSlowdown:
    vw: int
    wave: int = 0               # onset wave
    extra_s: float = 0.2        # extra seconds per wave from onset on

    def validate(self) -> None:
        if self.vw < 0 or self.wave < 0 or self.extra_s < 0:
            raise ValueError(f"WorkerSlowdown(vw={self.vw}, "
                             f"wave={self.wave}, extra_s={self.extra_s}) "
                             f"must be non-negative")


@dataclass(frozen=True)
class PSStall:
    at_push: int                # stall before applying this push number
    seconds: float = 0.1

    def validate(self) -> None:
        if self.at_push < 0 or self.seconds < 0:
            raise ValueError(f"PSStall(at_push={self.at_push}, "
                             f"seconds={self.seconds}) must be non-negative")


@dataclass(frozen=True)
class SlotFault:
    slot: int                   # decode-batch slot index
    step: int                   # global decode step the fault fires at

    def validate(self) -> None:
        if self.slot < 0 or self.step < 0:
            raise ValueError(f"SlotFault(slot={self.slot}, "
                             f"step={self.step}) must be non-negative")


@dataclass(frozen=True)
class ReplicaDown:
    replica: int                # Router replica index (partition.data)
    step: int                   # the replica's own decode step

    def validate(self) -> None:
        if self.replica < 0 or self.step < 0:
            raise ValueError(f"ReplicaDown(replica={self.replica}, "
                             f"step={self.step}) must be non-negative")


TRAIN_EVENTS = (LinkFault, WorkerCrash, WorkerSlowdown, PSStall)
SERVE_EVENTS = (SlotFault, ReplicaDown)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultPlan:
    """A frozen, validated set of fault events plus the seed that keys any
    probabilistic decision (message-loss draws)."""

    seed: int = 0
    events: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        self.validate()

    def validate(self) -> None:
        known = TRAIN_EVENTS + SERVE_EVENTS
        for ev in self.events:
            if not isinstance(ev, known):
                raise TypeError(f"unknown fault event {ev!r}; expected one "
                                f"of {[c.__name__ for c in known]}")
            ev.validate()

    def of_type(self, *kinds) -> list:
        return [e for e in self.events if isinstance(e, kinds)]

    def describe(self) -> str:
        by = {}
        for e in self.events:
            by[type(e).__name__] = by.get(type(e).__name__, 0) + 1
        inner = ", ".join(f"{k}x{v}" for k, v in sorted(by.items()))
        return f"FaultPlan(seed={self.seed}, {inner or 'empty'})"

    # ---- seeded scenario generators -----------------------------------
    @staticmethod
    def sample_train(seed: int, *, num_vw: int, max_waves: int,
                     with_crash: bool = True) -> "FaultPlan":
        """A deterministic random training chaos scenario: one VW crash
        (mid-run), one link-outage window on that worker's push path, one
        slowdown onset on another worker, and one PS stall."""
        rng = np.random.default_rng(seed)
        events = []
        crash_vw = int(rng.integers(0, num_vw))
        if with_crash and num_vw > 1:
            wave = int(rng.integers(1, max(2, max_waves // 2)))
            events.append(WorkerCrash(vw=crash_vw, wave=wave))
        victim = int(rng.integers(0, num_vw))
        events.append(LinkFault(src=f"vw{victim}", dst="ps",
                                start_msg=int(rng.integers(0, 3)),
                                n_msgs=int(rng.integers(1, 4)),
                                kind="outage"))
        if num_vw > 1:
            slow = (crash_vw + 1) % num_vw
            events.append(WorkerSlowdown(vw=slow,
                                         wave=int(rng.integers(0, 2)),
                                         extra_s=0.01))
        events.append(PSStall(at_push=int(rng.integers(0, max_waves)),
                              seconds=0.01))
        return FaultPlan(seed=seed, events=tuple(events))

    @staticmethod
    def sample_serve(seed: int, *, max_batch: int,
                     n_faults: int = 1) -> "FaultPlan":
        """A deterministic random serving chaos scenario: `n_faults` slot
        faults in the first few decode steps."""
        rng = np.random.default_rng(seed)
        events = tuple(SlotFault(slot=int(rng.integers(0, max_batch)),
                                 step=int(rng.integers(1, 5)) + 3 * i)
                       for i in range(n_faults))
        return FaultPlan(seed=seed, events=events)

    @staticmethod
    def sample_cluster(seed: int, *, replicas: int) -> "FaultPlan":
        """A deterministic random cluster chaos scenario: one replica of a
        data-parallel serve fleet dies early in its decode loop, forcing
        the Router to re-dispatch its unfinished requests."""
        rng = np.random.default_rng(seed)
        return FaultPlan(seed=seed, events=(
            ReplicaDown(replica=int(rng.integers(0, replicas)),
                        step=int(rng.integers(1, 4))),))


# ---------------------------------------------------------------------------
# recovery policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultPolicy:
    """How the runtime responds to faults. All time knobs are in *modeled*
    seconds (scaled by ClusterSpec.time_scale before sleeping, like every
    other simulated delay)."""

    # -- transport: per-message timeout + capped exponential backoff ----
    msg_timeout_s: float = 0.05     # modeled cost of one failed attempt
    max_retries: int = 8            # re-attempts before TransportError
    backoff_base_s: float = 0.01    # backoff = base * 2^retry, capped
    backoff_cap_s: float = 0.25

    # -- WSP gate ---------------------------------------------------------
    gate_timeout_s: float = 120.0   # host seconds at the staleness gate

    # -- fleet supervision: heartbeat-driven eviction + rejoin ------------
    # A worker's heartbeat is its WSP clock. The supervisor evicts a worker
    # when its clock lags the fleet max by >= evict_lag waves AND it is
    # either dead (thread exited) or has not advanced for stall_grace_s —
    # the lag (clock currency) is the detector, the grace only debounces
    # live-but-slow workers. evict_lag <= D guarantees detection fires
    # before survivors deadlock at the gate. 0 disables eviction.
    evict_lag: int = 0
    stall_grace_s: float = 1.0
    # A worker at clock 0 has not finished its first wave, which includes
    # its warm-up (cuBLAS handles, the caching allocator, first
    # launches) — an unpredictable, seconds-scale cost that would trip
    # stall_grace_s on a perfectly healthy fleet. Until the first wave lands
    # the stall detector uses this (much larger) grace instead.
    startup_grace_s: float = 60.0
    heartbeat_every_s: float = 0.05  # supervisor poll cadence (host s)
    # Rejoin an evicted/crashed worker once the global clock has advanced
    # `rejoin_after_waves` waves past its eviction point (deterministic,
    # clock currency), or after `rejoin_delay_s` host seconds — whichever
    # is set; None disables that trigger. Each worker rejoins at most
    # rejoin_max times.
    rejoin_after_waves: int | None = None
    rejoin_delay_s: float | None = None
    rejoin_max: int = 1

    # -- degraded completion ---------------------------------------------
    # fit() raises DegradedRunError when the run ends with gate timeouts
    # or unrecovered dead workers; True returns the TrainReport instead
    # (with the fault counters filled in).
    allow_degraded: bool = False

    # -- serving ----------------------------------------------------------
    slot_retry_budget: int = 1      # re-admissions per faulted request
    slot_recovery: str = "requeue"  # 'requeue' (replay from the prompt) |
                                    # 'reprefill' (rebuild the slot from
                                    # its still-mapped pages, keep tokens)
    quarantine_slots: bool = True   # faulted slots leave the free pool
    shed_after_faults: int = 0      # >0: refuse new admissions after N
                                    # slot faults (graceful load shedding)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for name in ("msg_timeout_s", "backoff_base_s", "backoff_cap_s",
                     "gate_timeout_s", "stall_grace_s", "startup_grace_s",
                     "heartbeat_every_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"FaultPolicy.{name} must be >= 0")
        for name in ("max_retries", "evict_lag", "rejoin_max",
                     "slot_retry_budget", "shed_after_faults"):
            if getattr(self, name) < 0:
                raise ValueError(f"FaultPolicy.{name} must be >= 0")
        if self.rejoin_after_waves is not None and self.rejoin_after_waves < 0:
            raise ValueError("FaultPolicy.rejoin_after_waves must be >= 0")
        if self.rejoin_delay_s is not None and self.rejoin_delay_s < 0:
            raise ValueError("FaultPolicy.rejoin_delay_s must be >= 0")
        if self.slot_recovery not in ("requeue", "reprefill"):
            raise ValueError(f"unknown slot_recovery "
                             f"{self.slot_recovery!r}; expected 'requeue' "
                             f"or 'reprefill'")

    @property
    def rejoins(self) -> bool:
        return (self.rejoin_after_waves is not None
                or self.rejoin_delay_s is not None) and self.rejoin_max > 0
