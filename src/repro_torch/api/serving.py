"""Continuous-batching request scheduler over the Engine's serve surface
(the port of repro.api.serving).

Engine.generate() runs one aligned batch: every slot prefills and retires
together. The Scheduler serves ragged traffic with the continuous-batching
loop over the paged cache (repro_torch.serve.cache):

  admit   pop queued requests into free batch slots — each admission
          allocates exactly the KV pages its prompt + generation budget
          needs from the CacheStore pool and is refused while the pool is
          exhausted; one variable-length prefill call (right-padded
          prompts + a per-row length vector) scatters K/V straight into
          the allocated pages. repro_torch.serve.memory quotes every
          admission (and, with ServeSpec.share_prefix / evict / preempt,
          maps shared prefixes, evicts cold pages, preempts a victim)
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


@dataclass
class Request:
    """One serving request: a prompt of at most serve.prompt_len token
    ids, an optional generation budget (0 -> serve.gen), and an optional
    deadline in decode steps (0 -> none; read by the "deadline" policy)."""

    rid: int
    prompt: Any                 # [<= prompt_len] token ids
    max_new_tokens: int = 0
    deadline: int = 0


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
            raise ValueError(f"{plan.arch.name} is a stub-frontend "
                             f"architecture (inputs are embeddings, not "
                             f"token ids); the scheduler feeds ids back")
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

    def run(self, requests, *, callback=None) -> ServeReport:
        """Serve `requests` to completion; `callback(step, active_slots)`
        fires after every batched decode step."""
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
        store = eng.serve_store()
        report = ServeReport(arch=plan.arch.name, backend=plan.run.backend,
                             max_batch=B, page_size=store.layout.page_size,
                             pages_total=store.pages_total)
        active: dict[int, _Slot] = {}
        free = list(range(B))
        step = 0
        tr = self.tracer
        t_start = time.monotonic()
        mm = MemoryManager(store, share_prefix=sv.share_prefix,
                           evict=sv.evict, preempt=sv.preempt,
                           policy=self.policy, metrics=tr.metrics)
        preempted_rids: set[int] = set()

        def release(s: int):
            mm.went_cold(store.free(s), step)
            free.append(s)
            free.sort()

        def retire(s: int, slot: _Slot):
            slot.stats.finished_step = step
            slot.stats.latency_s = time.monotonic() - slot.t_admit
            report.requests.append(slot.stats)
            release(s)
            tr.instant("sched", "retire", rid=slot.req.rid, slot=s,
                       step=step, tokens=len(slot.stats.tokens))

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

        while queue or active:
            # ---- admit: policy order into the lowest slots, page-gated --
            if free and queue:
                admits, taken, requeued = [], [], []
                order = self._admit_order([r for _, r in queue], step)
                for qi in order:
                    if not free:
                        break
                    prompt, r = queue[qi]
                    need = prompt.shape[0] + self._limit(r)
                    hit, pages, need_fresh = mm.plan_admit(prompt, need)
                    if not mm.make_room(need_fresh, protect=pages):
                        # pool exhausted: before refusing, try to preempt
                        # a victim (never a request preempted already)
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
                    prompts = np.zeros((B, P), np.int32)
                    lens = np.ones(B, np.int32)
                    for j, (r, prompt, _, _) in enumerate(admits):
                        prompts[j, :prompt.shape[0]] = prompt
                        lens[j] = prompt.shape[0]
                    t0 = time.monotonic()
                    with tr.span("sched", "prefill_group", group=group,
                                 rows=len(admits)):
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
                                             ttft_s=ttft)
                        tr.metrics.observe("serve/ttft_s", ttft)
                        slot = _Slot(r, stats, self._limit(r),
                                     next_pos=prompt.shape[0], last_tok=tok,
                                     t_admit=t0, prompt=prompt)
                        if len(stats.tokens) >= slot.limit:
                            retire(s, slot)
                        else:
                            active[s] = slot
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
                logits = logits.float().cpu().numpy()
            report.decode_s += time.monotonic() - t0
            report.decode_steps += 1
            report.slot_steps += len(active)
            report.page_steps += store.pages_in_use
            tr.counter("sched", "active_slots", len(active))
            tr.counter("sched", "pages_in_use", store.pages_in_use)
            step += 1
            # ---- advance / retire --------------------------------------
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
                callback(step, len(active))
        report.wall_s = time.monotonic() - t_start
        report.peak_pages = store.peak_pages
        report.prefix_hit_tokens = mm.prefix_hit_tokens
        report.pages_shared = mm.pages_shared
        report.cow_copies = store.cow_copies
        report.evictions = mm.evictions
        report.readmit_recomputes = mm.readmit_recomputes
        if mm.share_prefix and mm.prompt_tokens:
            tr.metrics.gauge_set("serve/prefix_hit_rate",
                                 mm.prefix_hit_tokens / mm.prompt_tokens)
        report.requests.sort(key=lambda r: r.rid)
        return eng.attach_telemetry(report)


def serve(engine: Engine, requests, *, callback=None) -> ServeReport:
    """One-shot convenience: Scheduler(engine).run(requests)."""
    return Scheduler(engine).run(requests, callback=callback)
