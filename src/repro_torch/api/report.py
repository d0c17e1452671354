"""Reports returned by the Engine, the Scheduler and the Router (the port of
repro.api.report).

TrainReport: one report type for the threaded WSP fleet, Engine.step()'s
fleet of one and the BSP all-reduce loop. ServeReport: its serving sibling,
assembled by Engine.generate() and the continuous-batching Scheduler, and
folded across a replica fleet by ServeReport.merge() (the Router's merged
report); Telemetry is the metrics snapshot attached when the run is
traced."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class Telemetry:
    """Aggregate observability state (a MetricsRegistry snapshot)."""

    counters: dict = field(default_factory=dict)
    gauges: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=dict)

    @classmethod
    def from_metrics(cls, registry) -> "Telemetry":
        snap = registry.snapshot()
        return cls(counters=snap["counters"], gauges=snap["gauges"],
                   histograms=snap["histograms"])

    def to_dict(self) -> dict:
        return {"counters": dict(self.counters), "gauges": dict(self.gauges),
                "histograms": dict(self.histograms)}

    def hist_quantile(self, name: str, q: float) -> Optional[float]:
        from repro_torch.obs.metrics import quantile_from_snapshot
        return quantile_from_snapshot(self.histograms.get(name), q)

    def staleness_max(self) -> Optional[float]:
        h = self.histograms.get("wsp/staleness")
        return h["max"] if h and h["count"] else None

    def link_utilization(self, wall_s: float) -> dict:
        """link name -> modeled busy fraction of the run's wall clock."""
        out = {}
        for k, v in self.gauges.items():
            if k.startswith("link/") and k.endswith("/modeled_s"):
                name = k.split("/", 2)[1]
                out[name] = min(1.0, v / wall_s) if wall_s > 0 else 0.0
        return out


@dataclass
class TrainReport:
    losses: list = field(default_factory=list)      # (wall_s, wid, loss)
    waves: int = 0
    wall_s: float = 0.0
    # wid -> seconds that worker spent blocked at its sync gate: WSP clock
    # waits (threads), or the per-wave straggler wait (bsp: the slowest
    # VW's wave time minus its own)
    wait_seconds: dict = field(default_factory=dict)
    telemetry: Optional[Telemetry] = None           # when tracing is enabled
    bytes_pushed: int = 0
    bytes_wire: int = 0
    comm_seconds: float = 0.0                       # modeled network time
    overlap_seconds: float = 0.0                    # comm hidden under compute
    push_wait_seconds: float = 0.0                  # comm NOT hidden (blocked)
    comm: dict = field(default_factory=dict)        # transport link stats
    # fault / recovery accounting (repro_torch.faults; zeros on fault-free
    # runs)
    waves_requested: int = 0    # max_waves * initial fleet size
    gate_timeouts: int = 0      # staleness gates that timed out (loud, not
                                # silent: fit() raises DegradedRunError
                                # unless FaultPolicy.allow_degraded)
    crashes: int = 0            # workers that died (injected or fail_at)
    late_pushes: int = 0        # pushes applied after the pusher left the
                                # clock (delta kept, clock untouched)
    ps_stalls: int = 0          # injected parameter-server apply stalls
    drops: int = 0              # transport attempts dropped
    retries: int = 0            # transport retries issued
    evictions: list = field(default_factory=list)   # (wid, at_clock,
                                                    #  reason, rejoined)
    rejoins: list = field(default_factory=list)     # successor wids

    def fault_digest(self) -> dict:
        """The run's canonical fault/recovery record, restricted to fields
        that are a deterministic function of the Plan: every entry is
        anchored to logical indices (wave numbers, per-path attempt
        counters), never to host timing. Two runs of the same seeded
        scenario must produce equal digests — on the CPU and on the card,
        and in the JAX package. Timing-sensitive observations (total waves
        including a rejoiner's, late_pushes, eviction clocks) stay on the
        report but out of the digest."""
        return {
            "waves_requested": self.waves_requested,
            "gate_timeouts": self.gate_timeouts,
            "crashes": self.crashes,
            "drops": self.drops,
            "retries": self.retries,
            "drops_by_link": dict(self.comm.get("drops_by_link", {})),
            "retries_by_link": dict(self.comm.get("retries_by_link", {})),
            "evictions": sorted((w, r) for w, _, r, _ in self.evictions),
            "rejoins": sorted(self.rejoins),
        }

    def loss_curve(self):
        """(wall_s, loss) arrays in wall-clock order. Sorts by the timestamp
        only (stable for ties), never by worker id."""
        pts = sorted(self.losses, key=lambda p: p[0])
        return (np.array([p[0] for p in pts]),
                np.array([p[2] for p in pts]))

    def losses_by_worker(self) -> dict:
        """wid -> loss sequence in push order (deterministic per worker even
        when wall-clock interleaving across workers is not)."""
        out: dict = {}
        for _, wid, loss in self.losses:
            out.setdefault(wid, []).append(loss)
        return out


@dataclass
class RequestStats:
    """Per-request accounting from the serving scheduler."""

    rid: int
    prompt_len: int = 0
    tokens: list = field(default_factory=list)    # generated token ids
    admitted_step: int = -1     # global decode step at admission
    finished_step: int = -1     # global decode step at retirement
    slot: int = -1              # batch slot the request occupied
    group: int = -1             # admission group: index of the batched
                                # prefill call this request rode in
    prefill_s: float = 0.0      # duration of that batched prefill call —
                                # shared by every request of its group, so
                                # summing it across requests over-counts
    ttft_s: float = 0.0         # arrival -> first token (end of this
                                # request's prefill group), wall clock
    latency_s: float = 0.0      # admission -> last token (wall clock)
    retries: int = 0            # slot-fault recoveries this request took
    shed: bool = False          # refused admission under fault pressure
    failed: bool = False        # retired without completing (retry budget
                                # exhausted)

    @property
    def new_tokens(self) -> int:
        return len(self.tokens)


@dataclass
class ServeReport:
    """Serving metrics for prefill/decode runs."""

    arch: str = ""
    backend: str = ""
    tokens: Any = None          # generate(): [B, gen] generated ids —
                                # scheduler runs use `requests`
    requests: list = field(default_factory=list)  # RequestStats
    prefill_s: float = 0.0      # total time inside prefill calls
    prefill_calls: int = 0      # batched prefill calls (admission groups)
    decode_s: float = 0.0       # total time inside decode calls
    decode_steps: int = 0       # batched decode calls issued
    slot_steps: int = 0         # sum over decode steps of active slots
    max_batch: int = 0
    wall_s: float = 0.0
    # paged-cache accounting (Scheduler runs; zeros for generate())
    page_size: int = 0          # tokens per KV page
    pages_total: int = 0        # physical pages in the pool
    peak_pages: int = 0         # high-water mark of pages in use
    page_steps: int = 0         # sum over decode steps of pages in use
    admit_blocked: int = 0      # admission rounds refused: pool exhausted
    # the serve step's parts, summed over the run from the tracer's spans
    # (Scheduler runs; 0 untraced): the host enqueueing the decode forward
    # (engine issue), the wait for the device (engine drain), the logits'
    # copy to the host (sched d2h), the picks, retiring and step
    # bookkeeping (sched pick), the admission rounds (sched admission)
    decode_issue_s: float = 0.0
    decode_drain_s: float = 0.0
    logits_d2h_s: float = 0.0
    pick_s: float = 0.0
    admit_s: float = 0.0
    # prompt tokens of every prefill call (kept untraced too): the real
    # ones, and the slots computed (b x s of the call's prompts array,
    # Engine.prefill_shape)
    prefill_tokens: int = 0
    prefill_slot_tokens: int = 0
    # recurrent state (SSD / RWKV6 models; zeros elsewhere): the bytes of
    # state and conv tails / token shifts the slots hold, and the slots
    # whose state an admission reset
    ssm_state_bytes: int = 0
    ssm_resets: int = 0
    # memory-manager accounting (repro_torch.serve.memory)
    prefix_hit_tokens: int = 0  # prompt tokens served from indexed pages
    pages_shared: int = 0       # prefix pages mapped by refcount (no copy)
    cow_copies: int = 0         # copy-on-write page duplications taken
    evictions: int = 0          # cold indexed pages reclaimed (LRU)
    readmit_recomputes: int = 0  # admissions that re-prefilled an evicted
    #                              prefix
    preemptions: int = 0        # in-flight requests preempted + replayed
    # fault / recovery accounting (repro_torch.faults; zeros on fault-free
    # runs)
    slot_faults: int = 0        # injected slot faults taken
    requeues: int = 0           # requests re-admitted after a slot fault
    reprefills: int = 0         # slots rebuilt in place from their pages
    quarantined: int = 0        # slots removed from the free pool
    shed: int = 0               # requests refused under fault pressure
    failed_requests: int = 0    # retired incomplete (retry budget spent)
    aborted_step: int = -1      # serving stopped early at this decode step
    #                             (a callback raised StopServing — e.g. a
    #                             replica died); -1 = ran to completion
    telemetry: Optional[Telemetry] = None  # when tracing is enabled
    # cluster serving (repro_torch.serve.router): merge() fills these on the
    # Router's merged report; empty on single-replica runs
    replicas: list = field(default_factory=list)  # per-replica sub-reports
    #                             (one per replica *run* — a survivor that
    #                             absorbed a re-dispatch round contributes
    #                             one sub-report per round)
    router: dict = field(default_factory=dict)    # Router counters:
    #                             dispatches per policy, affinity_hits,
    #                             rebalances, queue_depth_peak, rounds,
    #                             replica_downs

    @property
    def tokens_out(self) -> int:
        if self.requests:
            return sum(r.new_tokens for r in self.requests)
        if self.tokens is not None:
            return int(np.asarray(self.tokens).size)
        return 0

    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0

    def ms_per_token(self) -> float:
        """Mean wall milliseconds of one batched decode step."""
        return (self.decode_s / self.decode_steps * 1e3
                if self.decode_steps else 0.0)

    def occupancy(self) -> Optional[float]:
        """Mean fraction of decode-batch slots doing useful work (scheduler
        runs only). On a merged report each replica's slot-steps are
        weighed against its own capacity (decode_steps_i * max_batch_i):
        replicas step independently, so the merged max_batch (the fleet's
        total slots) times the summed decode steps would divide every
        replica's work by every other replica's steps."""
        if self.replicas:
            cap = sum(r.decode_steps * r.max_batch for r in self.replicas)
            if not cap:
                return None
            return sum(r.slot_steps for r in self.replicas) / cap
        if not self.decode_steps or not self.max_batch or not self.requests:
            return None
        return self.slot_steps / (self.decode_steps * self.max_batch)

    def mean_ttft(self) -> Optional[float]:
        """Mean arrival-to-first-token over requests (scheduler runs)."""
        if not self.requests:
            return None
        return float(np.mean([r.ttft_s for r in self.requests]))

    def page_utilization(self) -> Optional[float]:
        """Peak distinct pages in use as a fraction of the pool (scheduler
        runs only). On a merged report the fraction is pool-weighted: each
        pool-bearing replica's peak over the fleet's summed pools (pool-less
        families count on neither side), which is the plain ratio for a
        single replica."""
        if self.replicas:
            tot = sum(r.pages_total for r in self.replicas
                      if r.pages_total and r.decode_steps)
            if not tot:
                return None
            return sum(r.peak_pages for r in self.replicas
                       if r.pages_total and r.decode_steps) / tot
        if not self.decode_steps or not self.pages_total:
            return None
        return self.peak_pages / self.pages_total

    @classmethod
    def merge(cls, reports, *, router: Optional[dict] = None,
              wall_s: Optional[float] = None) -> "ServeReport":
        """Fold per-replica sub-reports into one fleet-level ServeReport.

        Additive counters (tokens, prefill/decode time and calls,
        slot-steps, page, memory and fault accounting) sum; `max_batch` and
        `pages_total` sum into the fleet's capacity; `requests` concatenate
        sorted by rid (the Router never splits or duplicates a request).
        `wall_s` defaults to the max over sub-reports — replicas run
        concurrently — and the Router passes its own measured wall instead.
        decode_s / prefill_s sum: they are compute-seconds across the fleet
        and may exceed wall_s. `occupancy()` and `page_utilization()` are
        replica-weighted; both equal the single report's for a one-element
        merge."""
        reports = list(reports)
        if not reports:
            raise ValueError("merge() needs at least one sub-report")
        out = cls(arch=reports[0].arch, backend=reports[0].backend,
                  replicas=reports, router=dict(router or {}))
        for r in reports:
            out.requests.extend(r.requests)
            for name in _MERGED_SUMS:
                setattr(out, name, getattr(out, name) + getattr(r, name))
            out.page_size = out.page_size or r.page_size
        out.wall_s = wall_s if wall_s is not None else \
            max(r.wall_s for r in reports)
        out.requests.sort(key=lambda r: r.rid)
        return out


# the ServeReport fields merge() sums over the sub-reports
_MERGED_SUMS = (
    "prefill_s", "prefill_calls", "decode_s", "decode_steps", "slot_steps",
    "max_batch", "pages_total", "peak_pages", "page_steps", "admit_blocked",
    "decode_issue_s", "decode_drain_s", "logits_d2h_s", "pick_s", "admit_s",
    "prefill_tokens", "prefill_slot_tokens", "ssm_state_bytes", "ssm_resets",
    "prefix_hit_tokens", "pages_shared", "cow_copies", "evictions",
    "readmit_recomputes", "preemptions", "slot_faults", "requeues",
    "reprefills", "quarantined", "shed", "failed_requests")
