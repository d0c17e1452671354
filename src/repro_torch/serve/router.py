"""Scale-out serving: heterogeneous data-parallel replicas behind a
topology-priced Router (the port of repro.serve.router).

HetPipe's thesis — data parallelism over *heterogeneous* virtual workers,
whimpy nodes included — applied to inference. A `Router` owns N serve
replicas (`partition.data`), each a full single-replica stack: its own
Engine, its own `CacheStore` page pool, its own `MemoryManager` prefix
index, its own continuous-batching `Scheduler` slot pool. Replicas may be
heterogeneous (`ServeSpec.replicas`): a whimpy replica shrinks
`max_batch` / `max_pages`, and the dispatch scoring steers short-prompt /
short-budget traffic its way — a long request is infeasible (or expensive)
on a small pool, a short one is cheap anywhere.

Dispatch policies (`ROUTER_POLICIES`):

  least_loaded  requests dispatch in arrival order; each goes to the
                replica minimizing load + net, where load counts the
                queue depth already booked against the replica's slots
                plus its page-pool pressure (pages_in_use + booked pages
                over pages_total), in units of a nominal decode-step cost
  deadline      requests dispatch in slack order (deadline minus tokens
                still needed, FIFO among ties) to the same min-cost
                replica; each replica's Scheduler also runs its
                "deadline" admission policy

Both are priced by `dist.topology` alpha-beta link costs: the client sits
at the topology's `ps` endpoint, and a dispatch pays the client->replica
path (`ClusterTopology.path_links`) for the prompt bytes out plus the
generated tokens back. A fast-but-far replica can lose to a near whimpy
one.

Session/prefix affinity: requests sharing a page-aligned prompt prefix
(the first `page_size`-token run) stick to one replica, first by probing
each live replica's `PrefixIndex` read-only (`index.match`) and then by a
sticky first-dispatch map for prefixes no index holds yet. Shared system
prompts thus hit one replica's refcounted pages instead of being
recomputed once per replica.

Streams: routing never changes a request's token stream. Picks are keyed
by (sample_seed, rid, k) and decode rows are independent of their
co-batched neighbours, so any assignment of requests to replicas —
including replay after a replica death — emits the streams a
single-replica Scheduler would (MoE capacity routing excepted). On the
card the replicas' different batch widths can change the GEMMs' summation
order, so f32 streams there agree except at a top-2 near-tie.

Replica death (`repro_torch.faults.ReplicaDown`): the victim's Scheduler
aborts via `StopServing` at its own decode step; retired requests keep
their streams, and the Router re-dispatches the unfinished remainder onto
the survivors in the next round, counted as rebalances.

The model parameters are made once, on the Router's device, and shared by
every replica Engine: three replicas hold one copy of the weights beside
three page pools. With more than one core the replicas run on host
threads (each launching its kernels on the thread's current stream, the
default stream); `wall_s` is the Router's measured wall, and
`router["modeled_fleet_wall_s"]` the busiest replica's.

    from repro_torch.api import get_preset
    from repro_torch.serve.router import Router
    report = Router(get_preset("serve_cluster"), device="cpu").run(requests)
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.api.engine import Engine, resolve_device
from repro_torch.api.plan import Plan, ReplicaSpec
from repro_torch.api.report import ServeReport, Telemetry
from repro_torch.api.serving import Scheduler, StopServing
from repro_torch.dist.topology import make_topology
from repro_torch.faults.plan import FaultPlan, ReplicaDown, SlotFault
from repro_torch.models import lm
from repro_torch.obs import NULL_TRACER
from repro_torch.serve import cache as cache_lib
from repro_torch.serve.memory import MemoryManager

ROUTER_POLICIES = ("least_loaded", "deadline")

_INFEASIBLE = float("inf")


class Replica:
    """One serve replica: a single-replica Plan (partition.data=1) run by
    its own Engine/Scheduler over a persistent CacheStore + MemoryManager
    (persistent so the prefix index stays warm across dispatch rounds and
    the Router can probe it read-only for affinity)."""

    def __init__(self, idx: int, plan: Plan, host: str, engine: Engine,
                 policy: str):
        self.idx = idx
        self.plan = plan
        self.host = host
        self.engine = engine
        self.scheduler = Scheduler(engine, policy=policy)
        self.store = engine.serve_store()
        sv = plan.serve
        self.mm = MemoryManager(self.store, share_prefix=sv.share_prefix,
                                evict=sv.evict, preempt=sv.preempt,
                                policy=policy,
                                metrics=engine.tracer.metrics)
        self.max_batch = sv.max_batch
        self.pages_total = self.store.pages_total
        self.down = False

    def pages_for(self, tokens: int) -> int:
        return self.store.layout.pages_for(tokens) if self.store._has_pool \
            else 0

    def prefix_hit(self, prompt) -> int:
        """Read-only affinity probe: prompt tokens this replica's index
        already holds pages for."""
        if not self.mm.share_prefix:
            return 0
        hit, _ = self.mm.index.match(prompt)
        return hit

    def describe(self) -> str:
        return (f"r{self.idx}@{self.host}: batch={self.max_batch} "
                f"pages={self.pages_total}")


class Router:
    """Owns the replica fleet of a data-parallel serve Plan
    (partition.data > 1) and routes requests.

    The Plan is the cluster-level spec: `ServeSpec.max_batch` / `max_pages`
    are the per-replica ceiling, `ServeSpec.replicas` shrinks individual
    replicas, `cluster.topology` prices dispatch (None = all replicas
    equidistant). The parameters are made once — as `Engine` makes them
    for a serve Plan: the serve compute dtype, a generator seeded
    `run.seed` on the Router's device — or taken from `params`, and shared
    by every replica Engine, so replicas are exact clones of the
    single-replica model. `device` is where every replica runs (None: the
    CUDA card, as `Engine` resolves it).

    `step_cost_s` is the nominal cost of one decode step used to convert
    queue depth and page pressure into seconds, the currency link costs
    are priced in — it sets how much queueing advantage a far replica
    must offer before beating a near one.
    """

    def __init__(self, plan: Plan, *, policy: str = "least_loaded",
                 tracer=None, step_cost_s: float = 2e-3,
                 parallel: Optional[bool] = None, params=None, device=None):
        if not isinstance(plan, Plan):
            raise TypeError(f"Router wants a Plan, got {type(plan).__name__}")
        if plan.serve is None:
            raise ValueError("the Router drives serve Plans; Plan.serve is "
                             "unset — give the Plan a ServeSpec")
        if plan.run.backend != "threads":
            raise ValueError("data-parallel serve replicas are threads-"
                             "backend only for now; the spmd mesh serves "
                             "as a single replica")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; expected "
                             f"one of {ROUTER_POLICIES}")
        self.plan = plan
        self.policy = policy
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.step_cost_s = step_cost_s
        self.device = resolve_device(device)
        if parallel is None:
            # threads only overlap where there are cores to overlap on; a
            # single-core host would just interleave the replicas and
            # contaminate each replica's measured wall with the others'
            # GIL slices (streams are the same either way)
            parallel = (os.cpu_count() or 1) > 1
        self.parallel = parallel
        sv, run = plan.serve, plan.run
        n = max(1, plan.partition.data)
        specs = list(sv.replicas) or [ReplicaSpec()] * n

        topo = plan.cluster.topology
        if isinstance(topo, str):
            topo = make_topology(topo, n)
        self.topology = topo

        # shared params: every replica is an exact clone of the model the
        # single-replica Engine would build (same arch, seed and dtype)
        if params is None:
            cdt, _ = cache_lib.serve_dtypes(run.compute_dtype,
                                            sv.cache_dtype)
            gen = torch.Generator(device=self.device).manual_seed(run.seed)
            params = lm.init_params(plan.arch, gen, dtype=cdt,
                                    device=self.device)
        self.params = params

        sched_policy = "deadline" if policy == "deadline" else "fifo"
        self.replicas: list[Replica] = []
        for i, spec in enumerate(specs):
            host = spec.host or f"vw{i}"
            if self.topology is not None:
                self.topology.link("ps", host)   # unknown hosts fail here
            rplan = plan.replace(
                partition__data=1,
                cluster__topology=None,
                serve__max_batch=spec.max_batch or sv.max_batch,
                serve__max_pages=spec.max_pages or sv.max_pages,
                serve__replicas=(),
                faults=self._replica_faults(i, spec.max_batch
                                            or sv.max_batch))
            eng = Engine(rplan, params=params, device=self.device,
                         tracer=self.tracer.scoped(f"r{i}/"))
            self.replicas.append(Replica(i, rplan, host, eng, sched_policy))

        # ReplicaDown events fire at the victim's own decode step
        self._down_at: dict[int, int] = {}
        if plan.faults is not None:
            for ev in plan.faults.of_type(ReplicaDown):
                self._down_at[ev.replica] = ev.step

        self._affinity: dict[tuple, int] = {}    # prefix key -> replica idx
        self._counters = {"dispatches": 0, "affinity_hits": 0,
                          "rebalances": 0, "queue_depth_peak": 0,
                          "rounds": 0, "replica_downs": 0}

    # ------------------------------------------------------------------
    def _replica_faults(self, idx: int, max_batch: int):
        """The per-replica FaultPlan: SlotFaults land on the first replica
        whose decode batch contains the named slot (deterministic — the
        cluster-level slot index has no replica attribution); ReplicaDown
        events are the Router's own and are stripped."""
        faults = self.plan.faults
        if faults is None:
            return None
        slots = faults.of_type(SlotFault)
        mine = []
        for ev in slots:
            owner = next((j for j, s in enumerate(
                list(self.plan.serve.replicas)
                or [ReplicaSpec()] * max(1, self.plan.partition.data))
                if ev.slot < (s.max_batch
                              or self.plan.serve.max_batch)), None)
            if owner == idx:
                mine.append(ev)
        if not mine:
            return None
        return FaultPlan(seed=faults.seed, events=tuple(mine))

    # ------------------------------------------------------------------
    # dispatch pricing
    # ------------------------------------------------------------------
    def _net_cost(self, host: str, nbytes: float) -> float:
        """Client->replica alpha-beta cost: the client sits at the
        topology's 'ps' endpoint; a replica on the ps host is free."""
        topo = self.topology
        if topo is None or host == topo.ps_host:
            return 0.0
        return sum(l.transfer_time(nbytes)
                   for l in topo.path_links(("ps", host)))

    def _limit(self, r) -> int:
        return r.max_new_tokens or self.plan.serve.gen

    def _score(self, rep: Replica, booked_depth: int, booked_pages: int,
               prompt_len: int, limit: int) -> float:
        """Dispatch cost (seconds) of sending this request to `rep`:
        queue + page pressure in decode-step currency, plus the priced
        client->replica round trip. inf = infeasible (the request could
        never be admitted there)."""
        need_pages = rep.pages_for(prompt_len + limit)
        if rep.pages_total and need_pages > rep.pages_total:
            return _INFEASIBLE
        load = (booked_depth / rep.max_batch) * self.step_cost_s
        if rep.pages_total:
            frac = (rep.store.pages_in_use + booked_pages + need_pages) \
                / rep.pages_total
            load += frac * self.step_cost_s
        net = self._net_cost(rep.host, 4.0 * prompt_len) \
            + self._net_cost(rep.host, 4.0 * limit)
        return load + net

    def _prefix_key(self, prompt) -> Optional[tuple]:
        """Affinity key: the first page-aligned token run of the prompt
        (requests sharing at least one full page of system prompt share
        the key). None when the prompt is shorter than a page or the
        family has no pool to share."""
        rep0 = self.replicas[0]
        ps = rep0.store.layout.page_size
        # mm.share_prefix is already gated on the family having a pool at
        # all (RWKV stores have no pages to share)
        if not rep0.mm.share_prefix or ps <= 0 or len(prompt) < ps:
            return None
        return tuple(int(t) for t in prompt[:ps])

    # ------------------------------------------------------------------
    def _dispatch(self, pending) -> dict[int, list]:
        """Assign every pending request to a live replica. Returns
        {replica idx: [Request, ...]} preserving arrival order within
        each replica (the Scheduler re-applies its own admission policy
        inside)."""
        tr = self.tracer
        live = [rep for rep in self.replicas if not rep.down]
        if not live:
            raise RuntimeError("every serve replica is down; nothing can "
                               "dispatch")
        if self.policy == "deadline":
            def slack(r):
                return (r.deadline - self._limit(r)) if r.deadline \
                    else float("inf")
            order = sorted(range(len(pending)),
                           key=lambda i: slack(pending[i]))
        else:
            order = list(range(len(pending)))
        booked_depth = {rep.idx: 0 for rep in live}
        booked_pages = {rep.idx: 0 for rep in live}
        assign: dict[int, list] = {rep.idx: [] for rep in live}
        for qi in order:
            r = pending[qi]
            prompt = np.asarray(r.prompt)
            plen = int(prompt.shape[0])
            limit = self._limit(r)

            def feasible(rep):
                return self._score(rep, booked_depth[rep.idx],
                                   booked_pages[rep.idx], plen,
                                   limit) < _INFEASIBLE

            chosen, via = None, "score"
            key = self._prefix_key(prompt)
            if key is not None:
                # live probe first: the replica whose PrefixIndex already
                # holds this prefix's pages wins (read-only match)
                hits = [(rep.prefix_hit(prompt), rep.idx) for rep in live]
                best_hit, best_idx = max(hits)
                if best_hit > 0 and feasible(self.replicas[best_idx]):
                    chosen, via = best_idx, "probe"
                elif key in self._affinity:
                    sticky = self._affinity[key]
                    rep = self.replicas[sticky]
                    if not rep.down and feasible(rep):
                        chosen, via = sticky, "sticky"
                    else:
                        # the affinity target is gone/full: rebalance
                        self._counters["rebalances"] += 1
                        tr.metrics.counter_inc("serve/router_rebalances")
            if chosen is None:
                scored = [(self._score(rep, booked_depth[rep.idx],
                                       booked_pages[rep.idx], plen, limit),
                           rep.idx) for rep in live]
                score, chosen = min(scored)
                if score == _INFEASIBLE:
                    raise ValueError(
                        f"request {r.rid} (prompt {plen} + gen {limit} "
                        f"tokens) fits no live replica's page pool; "
                        f"shrink the request or grow a replica "
                        f"({', '.join(rep.describe() for rep in live)})")
            rep = self.replicas[chosen]
            assign[chosen].append(r)
            booked_depth[chosen] += 1
            booked_pages[chosen] += rep.pages_for(plen + limit)
            if key is not None:
                self._affinity.setdefault(key, chosen)
            self._counters["dispatches"] += 1
            tr.metrics.counter_inc("serve/router_dispatches")
            if via != "score":
                self._counters["affinity_hits"] += 1
                tr.metrics.counter_inc("serve/router_affinity_hits")
                tr.instant("router", "affinity_hit", rid=r.rid,
                           replica=chosen, via=via)
            tr.instant("router", "dispatch", rid=r.rid, replica=chosen,
                       policy=self.policy, queue_depth=booked_depth[chosen])
        return assign

    # ------------------------------------------------------------------
    def _run_replica(self, rep: Replica, reqs: list) -> ServeReport:
        cb = None
        down_step = self._down_at.get(rep.idx)
        if down_step is not None:
            def cb(step, active, _t=down_step):
                if step >= _t:
                    raise StopServing()
        return rep.scheduler.run(reqs, callback=cb, store=rep.store,
                                 mm=rep.mm)

    def run(self, requests) -> ServeReport:
        """Route `requests` over the replica fleet to completion and
        return the merged ServeReport (per-replica sub-reports under
        `.replicas`, router counters under `.router`)."""
        tr = self.tracer
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique: the Router "
                             "tracks completion and replay by rid")
        t0 = time.monotonic()
        pending = list(requests)
        sub_reports: list[ServeReport] = []
        self._busy: dict[int, float] = {}
        while pending:
            depth = len(pending)
            self._counters["queue_depth_peak"] = max(
                self._counters["queue_depth_peak"], depth)
            tr.counter("router", "queue_depth", depth)
            if self._counters["rounds"]:
                # everything here survived a replica death: requeued
                self._counters["rebalances"] += depth
                tr.metrics.counter_inc("serve/router_rebalances", depth)
            assign = self._dispatch(pending)
            active = {i: reqs for i, reqs in assign.items() if reqs}
            with tr.span("router", "round",
                         round=self._counters["rounds"],
                         requests=depth, replicas=len(active)):
                if self.parallel and len(active) > 1:
                    with ThreadPoolExecutor(max_workers=len(active)) as ex:
                        futs = {i: ex.submit(self._run_replica,
                                             self.replicas[i], reqs)
                                for i, reqs in active.items()}
                        results = {i: f.result() for i, f in futs.items()}
                else:
                    results = {i: self._run_replica(self.replicas[i], reqs)
                               for i, reqs in active.items()}
            done = set()
            for i, rep_report in sorted(results.items()):
                rep_report.router = {"replica": i}
                self._busy[i] = self._busy.get(i, 0.0) + rep_report.wall_s
                sub_reports.append(rep_report)
                done |= {s.rid for s in rep_report.requests}
                if rep_report.aborted_step >= 0:
                    self.replicas[i].down = True
                    self._down_at.pop(i, None)
                    self._counters["replica_downs"] += 1
                    tr.instant("router", "replica_down", replica=i,
                               step=rep_report.aborted_step)
                    tr.metrics.counter_inc("fault/replica_downs")
            survivors = [r for r in pending if r.rid not in done]
            if len(survivors) == len(pending):
                raise RuntimeError(
                    f"dispatch round {self._counters['rounds']} completed "
                    f"no requests; refusing to spin "
                    f"({len(pending)} pending)")
            pending = survivors
            self._counters["rounds"] += 1
        wall = time.monotonic() - t0
        tr.metrics.gauge_set("serve/router_queue_depth",
                             self._counters["queue_depth_peak"])
        router = dict(self._counters)
        router["policy"] = self.policy
        router["replicas"] = len(self.replicas)
        router["dispatches_by_policy"] = {
            self.policy: self._counters["dispatches"]}
        # modeled fleet wall: each replica rides its own node in the
        # deployment the Plan describes, so fleet latency is the busiest
        # replica's wall, not the sum a single shared host serializes
        # (wall_s above stays the measured host wall)
        router["modeled_fleet_wall_s"] = max(self._busy.values(),
                                             default=wall)
        merged = ServeReport.merge(sub_reports, router=router, wall_s=wall)
        if tr.enabled:
            merged.telemetry = Telemetry.from_metrics(tr.metrics)
        return merged


def route(plan: Plan, requests, **kw) -> ServeReport:
    """One-shot convenience: Router(plan, **kw).run(requests)."""
    return Router(plan, **kw).run(requests)
