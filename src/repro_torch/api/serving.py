"""Continuous-batching request scheduler over the Engine's serve surface
(the port of repro.api.serving).

Engine.generate() runs one aligned batch: every slot prefills and retires
together. The Scheduler serves ragged traffic with the continuous-batching
loop over the paged cache (repro_torch.serve.cache):

  admit   pop queued requests into free batch slots — each admission
          allocates exactly the KV pages its prompt + generation budget
          needs from the CacheStore pool and is refused while the pool is
          exhausted; one variable-length prefill call (right-padded
          prompts + a per-row length vector, at Engine.prefill_shape: the
          admitted rows at their longest prompt rounded up to 64, or
          [max_batch, prompt_len] where rows couple) scatters K/V
          straight into the allocated pages. repro_torch.serve.memory
          quotes every admission (and, with ServeSpec.share_prefix /
          evict / preempt, maps shared prefixes, evicts cold pages,
          preempts a victim)
  decode  one decode call advances every active slot by one token; slots
          sit at different depths, carried by the per-row position vector,
          and full-attention K/V is read through each slot's block table
  retire  finished sequences free their pages and slots

Admission policy: "fifo" admits in arrival order; "deadline" orders the
queue by slack (deadline - step - tokens still needed), FIFO among ties.
Token picks are keyed by (sample_seed, rid, k): a request's output never
depends on its co-batched neighbours. Greedy streams equal the JAX
package's; sampled ones use a torch.Generator and differ from jax.random.

    from repro_torch.api import Engine, get_preset
    from repro_torch.api.serving import Request, Scheduler
    eng = Engine(get_preset("serve_kernels"))
    report = Scheduler(eng).run([Request(rid=i, prompt=p) for i, p in ...])
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.api.engine import Engine, sample_key
from repro_torch.api.report import RequestStats, ServeReport
from repro_torch.serve.memory import MemoryManager

POLICIES = ("fifo", "deadline")

# ServeReport's serve-step totals and the spans (track, name) they sum
_STEP_PARTS = (("decode_issue_s", "engine", "issue"),
               ("decode_drain_s", "engine", "drain"),
               ("logits_d2h_s", "sched", "d2h"),
               ("pick_s", "sched", "pick"),
               ("admit_s", "sched", "admission"))


@dataclass
class Request:
    """One serving request: a prompt of at most serve.prompt_len token
    ids, an optional generation budget (0 -> serve.gen), and an optional
    deadline in decode steps (0 -> none; read by the "deadline" policy)."""

    rid: int
    prompt: Any                 # [<= prompt_len] token ids
    max_new_tokens: int = 0
    deadline: int = 0


class StopServing(Exception):
    """Raised by a run() callback to abort serving mid-run. The Scheduler
    stops immediately and returns a report covering only the requests
    already retired (aborted_step marks where); in-flight and queued
    requests are absent, so the caller can re-dispatch them (replay from
    the prompt is exact: token picks are keyed by (sample_seed, rid, k))."""


class _Slot:
    """An in-flight request occupying one decode-batch row."""

    __slots__ = ("req", "stats", "limit", "next_pos", "last_tok", "t_admit",
                 "prompt")

    def __init__(self, req, stats, limit, next_pos, last_tok, t_admit,
                 prompt):
        self.req, self.stats, self.limit = req, stats, limit
        self.next_pos, self.last_tok = next_pos, last_tok
        self.t_admit = t_admit
        self.prompt = prompt


class Scheduler:
    def __init__(self, engine: Engine, *, policy: str = "fifo"):
        plan = engine.plan
        if plan.serve is None:
            raise ValueError("the Scheduler drives serve Plans; Plan.serve "
                             "is unset — give the Plan a ServeSpec")
        if plan.arch.frontend != "none":
            raise ValueError(
                f"{plan.arch.name} is a stub-frontend architecture (inputs "
                f"are precomputed embeddings, not token ids); the request "
                f"scheduler feeds generated ids back — serve it through "
                f"Engine.generate() instead")
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"expected one of {POLICIES}")
        self.engine = engine
        self.sv = plan.serve
        self.policy = policy
        self.tracer = engine.tracer

    # ------------------------------------------------------------------
    def _pick_one(self, row, rid: int, k: int) -> int:
        """Next token for one request from its f32 logits row (numpy),
        keyed by (rid, k) so co-batching never changes a sample stream."""
        if self.sv.temperature == 0:
            return int(np.argmax(row))
        g = torch.Generator().manual_seed(
            sample_key(self.sv.sample_seed, rid, k))
        probs = torch.softmax(torch.from_numpy(
            np.asarray(row, np.float32)) / self.sv.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=g))

    def _limit(self, r: Request) -> int:
        return r.max_new_tokens or self.sv.gen

    def _admit_order(self, queue, step):
        """Indices into `queue` in admission order: FIFO, or by deadline
        slack with a stable sort (equal slack keeps FIFO order)."""
        if self.policy == "fifo":
            return list(range(len(queue)))

        def slack(r):
            return (r.deadline - step - self._limit(r)) if r.deadline \
                else float("inf")
        return sorted(range(len(queue)), key=lambda i: slack(queue[i]))

    def run(self, requests, *, callback=None, store=None,
            mm=None) -> ServeReport:
        """Serve `requests` to completion; `callback(step, active_slots)`
        fires after every batched decode step (raise StopServing from it
        to abort). `store` / `mm` inject a persistent CacheStore +
        MemoryManager (the Router's replicas keep theirs warm across
        dispatch rounds, so a re-dispatched shared prefix still hits the
        index); by default both are made fresh for this run. Under the
        Plan's FaultPlan, SlotFaults fire at their decode step: the slot is
        quarantined and its request requeued (replayed from the prompt) or
        reprefilled (rebuilt from prompt + generated tokens) within
        FaultPolicy.slot_retry_budget."""
        eng, sv = self.engine, self.sv
        B, P = sv.max_batch, sv.prompt_len
        plan = eng.plan
        queue = [(np.asarray(r.prompt), r) for r in requests]
        for prompt, r in queue:
            if prompt.ndim != 1 or not 1 <= prompt.shape[0] <= P:
                raise ValueError(
                    f"request {r.rid}: prompt shape {prompt.shape} must be "
                    f"[1..{P}] token ids (ServeSpec.prompt_len); shorter "
                    f"prompts are right-padded")
            if not 0 <= r.max_new_tokens <= sv.gen:
                raise ValueError(
                    f"request {r.rid}: max_new_tokens={r.max_new_tokens} "
                    f"must be in [0 (= the ServeSpec default), "
                    f"ServeSpec.gen={sv.gen}]")
            if r.deadline < 0:
                raise ValueError(f"request {r.rid}: deadline must be >= 0 "
                                 f"(0 = none), got {r.deadline}")
        if (store is None) != (mm is None):
            raise ValueError("store and mm persist together: inject both "
                             "(the mm indexes that store's pages) or "
                             "neither")
        if store is None:
            store = eng.serve_store()
        elif mm.store is not store:
            raise ValueError("the injected MemoryManager indexes a "
                             "different CacheStore than the one passed")
        report = ServeReport(arch=plan.arch.name, backend=plan.run.backend,
                             max_batch=B, page_size=store.layout.page_size,
                             pages_total=store.pages_total)
        active: dict[int, _Slot] = {}
        free = list(range(B))
        step = 0
        tr = self.tracer
        t_start = time.monotonic()
        if mm is None:
            mm = MemoryManager(store, share_prefix=sv.share_prefix,
                               evict=sv.evict, preempt=sv.preempt,
                               policy=self.policy, metrics=tr.metrics)
        # a persistent store/mm carries counters from earlier runs; report
        # this run's contribution as deltas from these baselines
        base = (mm.prefix_hit_tokens, mm.pages_shared, mm.evictions,
                mm.readmit_recomputes, store.cow_copies, store.ssm_resets)
        report.ssm_state_bytes = store.ssm_state_bytes
        base_s = [tr.total(track, name) for _, track, name in _STEP_PARTS]
        preempted_rids: set[int] = set()
        injector = eng.fault_injector()
        fpol = plan.fault_policy
        quarantined: set[int] = set()
        retries_by_rid: dict[int, int] = {}

        def release(s: int):
            mm.went_cold(store.free(s), step)
            if s not in quarantined:
                free.append(s)
                free.sort()

        def retire(s: int, slot: _Slot):
            slot.stats.finished_step = step
            slot.stats.latency_s = time.monotonic() - slot.t_admit
            report.requests.append(slot.stats)
            release(s)
            tr.instant("sched", "retire", rid=slot.req.rid, slot=s,
                       step=step, tokens=len(slot.stats.tokens))

        def shed_queue(reason: str):
            for prompt, r in queue:
                stats = RequestStats(rid=r.rid, prompt_len=prompt.shape[0],
                                     shed=True)
                report.requests.append(stats)
                report.shed += 1
                tr.instant("sched", "shed", rid=r.rid, step=step,
                           reason=reason)
                tr.metrics.counter_inc("fault/shed")
            queue.clear()

        def requeue(s: int, slot: _Slot):
            """Recover by replay: the request goes back to the *front* of
            the queue and re-prefills from its prompt. Token picks are
            keyed by (rid, k), so the replayed stream equals the one a
            fault-free scheduler would have produced."""
            del active[s]
            release(s)
            queue.insert(0, (slot.prompt, slot.req))
            report.requeues += 1
            tr.instant("sched", "requeue", rid=slot.req.rid, slot=s,
                       step=step, retries=slot.stats.retries)
            tr.metrics.counter_inc("fault/requeues")

        def preempt_slot(s: int):
            """Release an in-flight request's pages and replay it from the
            prompt later: its picks are keyed by (rid, k), so the replayed
            stream equals the uninterrupted one."""
            slot = active.pop(s)
            release(s)
            preempted_rids.add(slot.req.rid)
            report.preemptions += 1
            tr.instant("sched", "preempt", rid=slot.req.rid, slot=s,
                       step=step, tokens=len(slot.stats.tokens))
            tr.metrics.counter_inc("serve/preemptions")
            return (slot.prompt, slot.req)

        def fail_request(s: int, slot: _Slot):
            slot.stats.failed = True
            report.failed_requests += 1
            tr.instant("sched", "request_failed", rid=slot.req.rid, slot=s,
                       step=step, retries=slot.stats.retries)
            del active[s]
            retire(s, slot)

        def try_reprefill(s: int, slot: _Slot) -> bool:
            """Recover in place: rebuild the slot's cache by prefilling
            prompt + already-generated tokens (the request keeps its
            tokens; only the transient per-slot state is rebuilt). Only
            possible while that sequence still fits the prefill width —
            False falls back to requeue."""
            seq = np.concatenate([
                np.asarray(slot.prompt, np.int32),
                np.asarray(slot.stats.tokens[:-1], np.int32)])
            if seq.shape[0] > P:
                return False
            del active[s]
            mm.went_cold(store.free(s), step)
            if s in quarantined:
                if not free:
                    return False        # no healthy slot left to rebuild on
                s2 = free.pop(0)
            else:
                s2 = s
            need = slot.stats.prompt_len + slot.limit
            if not mm.make_room(store.layout.pages_for(need)
                                if store._has_pool else 0):
                # the slot's own prompt pages went cold under an index
                # hold and eviction can't reclaim enough — replay instead
                if s2 != s or s not in quarantined:
                    free.append(s2)
                    free.sort()
                return False
            store.alloc(s2, need)
            b, w = eng.prefill_shape(1, seq.shape[0])
            prompts = np.zeros((b, w), np.int32)
            prompts[0, :seq.shape[0]] = seq
            lens = np.ones(b, np.int32)
            lens[0] = seq.shape[0]
            report.prefill_tokens += int(seq.shape[0])
            report.prefill_slot_tokens += b * w
            t0 = time.monotonic()
            with tr.span("sched", "reprefill", rid=slot.req.rid, slot=s2,
                         depth=int(seq.shape[0]), width=w):
                eng.prefill_into(store, prompts, lens, [s2])
            report.prefill_s += time.monotonic() - t0
            report.prefill_calls += 1
            report.reprefills += 1
            slot.stats.slot = s2
            active[s2] = slot
            tr.metrics.counter_inc("fault/reprefills")
            return True

        def inject_slot_faults():
            """Fire this decode step's injected slot faults: quarantine the
            slot and recover its request under the retry budget."""
            for s in injector.slot_faults(step):
                report.slot_faults += 1
                tr.instant("sched", "slot_fault", slot=s, step=step)
                tr.metrics.counter_inc("fault/slot_faults")
                if fpol.quarantine_slots and s not in quarantined:
                    quarantined.add(s)
                    report.quarantined += 1
                    if s in free:
                        free.remove(s)
                slot = active.get(s)
                if slot is None:
                    continue            # the faulted slot was empty
                slot.stats.retries += 1
                retries_by_rid[slot.req.rid] = slot.stats.retries
                if slot.stats.retries > fpol.slot_retry_budget:
                    fail_request(s, slot)
                elif fpol.slot_recovery == "reprefill" \
                        and try_reprefill(s, slot):
                    pass
                else:
                    if s in active:     # a failed reprefill freed the slot
                        requeue(s, slot)
                    else:
                        queue.insert(0, (slot.prompt, slot.req))
                        report.requeues += 1
                        tr.metrics.counter_inc("fault/requeues")

        faulted_steps: set[int] = set()
        while queue or active:
            # ---- graceful degradation under sustained fault pressure ----
            if queue and fpol.shed_after_faults \
                    and report.slot_faults >= fpol.shed_after_faults:
                shed_queue("fault_pressure")
            if queue and not active and not free:
                # every slot is quarantined: nothing can ever be admitted
                # again — shed the remainder instead of spinning forever
                shed_queue("no_healthy_slots")
            # ---- admit: policy order into the lowest slots, page-gated --
            admits = []
            if free and queue:
                # one admission round's host work: the order, the pages,
                # the padded prompt array (the prefill is its own span)
                with tr.span("sched", "admission", step=step):
                    taken, requeued = [], []
                    order = self._admit_order([r for _, r in queue], step)
                    for qi in order:
                        if not free:
                            break
                        prompt, r = queue[qi]
                        need = prompt.shape[0] + self._limit(r)
                        hit, pages, need_fresh = mm.plan_admit(prompt, need)
                        if not mm.make_room(need_fresh, protect=pages):
                            # pool exhausted: before refusing, try to
                            # preempt a victim (never a request preempted
                            # already)
                            vict = (mm.victim(active, step, need_fresh)
                                    if r.rid not in preempted_rids else None)
                            if vict is not None:
                                requeued.append(preempt_slot(vict))
                            if vict is None or not mm.make_room(
                                    need_fresh, protect=pages):
                                report.admit_blocked += 1
                                tr.instant("sched", "refuse", rid=r.rid,
                                           step=step, need_tokens=need,
                                           pages_in_use=store.pages_in_use)
                                break
                        s = free.pop(0)
                        skip = mm.admit(s, prompt, need, hit, pages, step)
                        taken.append(qi)
                        admits.append((r, prompt, s, skip))
                    for qi in sorted(taken, reverse=True):
                        del queue[qi]
                    for item in reversed(requeued):
                        queue.insert(0, item)
                    if admits:
                        group = report.prefill_calls
                        for r, prompt, s, skip in admits:
                            tr.instant("sched", "admit", rid=r.rid, slot=s,
                                       step=step, group=group,
                                       prompt_len=prompt.shape[0],
                                       shared_pages=skip,
                                       pages_in_use=store.pages_in_use)
                        b, w = eng.prefill_shape(len(admits), max(
                            prompt.shape[0] for _, prompt, _, _ in admits))
                        prompts = np.zeros((b, w), np.int32)
                        lens = np.ones(b, np.int32)
                        for j, (r, prompt, _, _) in enumerate(admits):
                            prompts[j, :prompt.shape[0]] = prompt
                            lens[j] = prompt.shape[0]
            if admits:
                report.prefill_tokens += int(lens[:len(admits)].sum())
                report.prefill_slot_tokens += b * w
                t0 = time.monotonic()
                with tr.span("sched", "prefill_group", group=group,
                             rows=len(admits), width=w):
                    logits = eng.prefill_into(
                        store, prompts, lens,
                        [s for _, _, s, _ in admits],
                        skip_pages=[skip for *_, skip in admits])
                    logits = logits.float().cpu().numpy()
                dt = time.monotonic() - t0
                report.prefill_s += dt
                report.prefill_calls += 1
                # TTFT: arrival (run start) to the end of this group's
                # prefill
                ttft = time.monotonic() - t_start
                for j, (r, prompt, s, _) in enumerate(admits):
                    tok = self._pick_one(logits[j], r.rid, 0)
                    stats = RequestStats(rid=r.rid,
                                         prompt_len=prompt.shape[0],
                                         tokens=[tok],
                                         admitted_step=step, slot=s,
                                         group=group, prefill_s=dt,
                                         ttft_s=ttft,
                                         retries=retries_by_rid.get(
                                             r.rid, 0))
                    tr.metrics.observe("serve/ttft_s", ttft)
                    slot = _Slot(r, stats, self._limit(r),
                                 next_pos=prompt.shape[0], last_tok=tok,
                                 t_admit=t0, prompt=prompt)
                    if len(stats.tokens) >= slot.limit:
                        retire(s, slot)
                    else:
                        active[s] = slot
            # ---- injected slot faults fire at their decode step ---------
            if injector is not None and step not in faulted_steps:
                # consulted once per step value: a recovery that empties
                # the batch loops back here without re-firing the fault
                faulted_steps.add(step)
                inject_slot_faults()
            if not active:
                continue
            # ---- one batched decode step over every active slot ---------
            toks = np.zeros((B, 1), np.int32)
            pos = np.zeros(B, np.int32)
            for s, slot in active.items():
                toks[s, 0] = slot.last_tok
                pos[s] = slot.next_pos
            t0 = time.monotonic()
            with tr.span("sched", "decode_step", step=step,
                         slots=len(active), pages=store.pages_in_use):
                logits, _ = eng.decode(toks, store, pos)
                with tr.span("sched", "d2h"):
                    logits = logits.float().cpu().numpy()
            report.decode_s += time.monotonic() - t0
            # ---- advance / retire: the step's host picks and bookkeeping
            with tr.span("sched", "pick", step=step):
                report.decode_steps += 1
                report.slot_steps += len(active)
                report.page_steps += store.pages_in_use
                tr.counter("sched", "active_slots", len(active))
                tr.counter("sched", "pages_in_use", store.pages_in_use)
                step += 1
                for s in sorted(active):
                    slot = active[s]
                    tok = self._pick_one(logits[s], slot.req.rid,
                                         len(slot.stats.tokens))
                    slot.stats.tokens.append(tok)
                    slot.next_pos += 1
                    slot.last_tok = tok
                    if len(slot.stats.tokens) >= slot.limit:
                        del active[s]
                        retire(s, slot)
            if callback is not None:
                try:
                    callback(step, len(active))
                except StopServing:
                    # abort (e.g. the replica died): report only what
                    # retired; the Router replays the rest on the
                    # survivors (picks are keyed by (rid, k))
                    report.aborted_step = step
                    tr.instant("sched", "aborted", step=step,
                               in_flight=len(active), queued=len(queue))
                    break
        report.wall_s = time.monotonic() - t_start
        report.peak_pages = store.peak_pages
        report.prefix_hit_tokens = mm.prefix_hit_tokens - base[0]
        report.pages_shared = mm.pages_shared - base[1]
        report.cow_copies = store.cow_copies - base[4]
        report.ssm_resets = store.ssm_resets - base[5]
        tr.metrics.gauge_set("serve/ssm_state_bytes", report.ssm_state_bytes)
        if report.ssm_state_bytes:
            tr.metrics.counter_inc("serve/ssm_resets", report.ssm_resets)
        report.evictions = mm.evictions - base[2]
        report.readmit_recomputes = mm.readmit_recomputes - base[3]
        for (attr, track, name), b in zip(_STEP_PARTS, base_s):
            setattr(report, attr, tr.total(track, name) - b)
        if mm.share_prefix and mm.prompt_tokens:
            tr.metrics.gauge_set("serve/prefix_hit_rate",
                                 mm.prefix_hit_tokens / mm.prompt_tokens)
        report.requests.sort(key=lambda r: r.rid)
        return eng.attach_telemetry(report)


def serve(engine: Engine, requests, *, callback=None) -> ServeReport:
    """One-shot convenience: Scheduler(engine).run(requests)."""
    return Scheduler(engine).run(requests, callback=callback)
