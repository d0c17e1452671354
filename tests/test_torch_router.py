"""The port's Router (repro_torch.serve.router) on the CPU: every case of
tests/test_router.py against the port — plan validation for replica
fleets, FIFO without starvation, prefix affinity on one replica, topology
pricing, deadline slack order, streams equal to the single-replica
Scheduler oracle on all three serve families (sampled included: both sides
are the port's, trap T2), replica-down re-dispatch, ServeReport.merge — and
what the port adds: exact launch counts under threads, counter deltas over
persistent pools across rounds, the presets' and the CLI's Router demos,
and the CUDA default device. Imports no jax."""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import (ClusterSpec, Engine, FaultPlan, PartitionSpec,
                             Plan, ReplicaDown, ReplicaSpec, RunSpec,
                             ServeSpec)
from repro_torch.api.report import ServeReport
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.obs import Tracer
from repro_torch.serve.router import ROUTER_POLICIES, Router

SERVE_ARCHS = ("qwen3-0.6b", "h2o-danube-1.8b", "rwkv6-3b")
CPU = dict(device="cpu")


def _cfg(name: str = "qwen3-0.6b", **over):
    base = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256,
                num_microbatches=2)
    if ARCHS[name].attn_type == "swa":
        base["window_size"] = 6
    base.update(over)
    return reduced(ARCHS[name], **base)


def _sv(**over):
    base = dict(prompt_len=8, gen=4, max_batch=4, page_size=4)
    base.update(over)
    return ServeSpec(**base)


def _reqs(seed, n, *, vocab=256, pmax=8, gen=4, shared=0, deadline=False):
    """n seeded requests; the first `shared` share one full-page prompt."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, pmax, dtype=np.int32)
    out = []
    for i in range(n):
        if i < shared:
            prompt = common.copy()
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(2, pmax + 1)),
                                  dtype=np.int32)
        out.append(Request(rid=i, prompt=prompt,
                           max_new_tokens=int(rng.integers(1, gen + 1)),
                           deadline=int(rng.integers(gen, 6 * gen))
                           if deadline else 0))
    return out


def _fresh(reqs):
    return [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                    max_new_tokens=r.max_new_tokens) for r in reqs]


def _streams(report):
    return {s.rid: list(s.tokens) for s in report.requests}


# ---------------------------------------------------------------------------
# Plan validation: the data-parallel serve lift
# ---------------------------------------------------------------------------
def test_cluster_plan_validation():
    cfg = _cfg()
    # replicas ride partition.data on the threads backend
    plan = Plan(arch=cfg, serve=_sv(), partition=PartitionSpec(data=2))
    assert "replicas=2" in plan.describe()
    with pytest.raises(ValueError, match="data"):
        Plan(arch=cfg, serve=_sv(), partition=PartitionSpec(data=0))
    # spmd serve keeps one replica on the mesh (tests/test_router.py:68-77),
    # and the Router drives threads replicas only
    with pytest.raises(ValueError, match="data-parallel serve"):
        Plan(arch=cfg, serve=_sv(), run=RunSpec(backend="spmd"),
             partition=PartitionSpec(stages=2, tp=1, data=2, devices=4))
    with pytest.raises(ValueError, match="data-parallel serve"):
        Plan(arch=cfg, serve=_sv(replicas=(ReplicaSpec(), ReplicaSpec())),
             run=RunSpec(backend="spmd"),
             partition=PartitionSpec(stages=2, tp=1, data=1, devices=2))
    with pytest.raises(ValueError, match="threads-backend only"):
        Router(Plan(arch=cfg, serve=_sv(), run=RunSpec(backend="spmd"),
                    partition=PartitionSpec(stages=2, tp=1, data=1)), **CPU)
    # per-replica specs must match the fleet size and fit the ceiling
    with pytest.raises(ValueError, match="replicas"):
        Plan(arch=cfg, serve=_sv(replicas=(ReplicaSpec(max_batch=2),)),
             partition=PartitionSpec(data=2))
    with pytest.raises(ValueError, match="max_batch"):
        Plan(arch=cfg, serve=_sv(replicas=(ReplicaSpec(max_batch=8),
                                           ReplicaSpec(max_batch=2))),
             partition=PartitionSpec(data=2))
    with pytest.raises(ValueError, match="max_pages"):
        Plan(arch=cfg, serve=_sv(max_pages=12,
                                 replicas=(ReplicaSpec(),
                                           ReplicaSpec(max_pages=16))),
             partition=PartitionSpec(data=2))
    with pytest.raises(TypeError, match="ReplicaSpec"):
        Plan(arch=cfg, serve=_sv(replicas=(object(),)))
    # a whimpy replica still has to hold one worst-case request
    with pytest.raises(ValueError, match="worst-case"):
        Plan(arch=cfg, serve=_sv(max_pages=24,
                                 replicas=(ReplicaSpec(max_batch=4),
                                           ReplicaSpec(max_batch=2,
                                                       max_pages=1))),
             partition=PartitionSpec(data=2))
    # topology prices the Router; other cluster knobs stay train-side
    Plan(arch=cfg, serve=_sv(), partition=PartitionSpec(data=2),
         cluster=ClusterSpec(topology="hetero"))
    with pytest.raises(ValueError, match="batches requests"):
        Plan(arch=cfg, serve=_sv(), partition=PartitionSpec(data=2),
             cluster=ClusterSpec(num_vw=2, topology="hetero"))
    with pytest.raises(ValueError):
        Plan(arch=cfg, serve=_sv(), partition=PartitionSpec(data=2),
             cluster=ClusterSpec(topology="no-such-topology"))
    # partition.data still means the spmd mesh on a train Plan
    with pytest.raises(ValueError, match="Router replicas"):
        Plan(arch=cfg, partition=PartitionSpec(data=2))


def test_replica_down_validation():
    cfg = _cfg()
    with pytest.raises(ValueError, match="non-negative"):
        FaultPlan(seed=0, events=(ReplicaDown(replica=-1, step=0),))
    # a single-replica plan has no survivor to re-dispatch onto
    with pytest.raises(ValueError, match="survivor"):
        Plan(arch=cfg, serve=_sv(),
             faults=FaultPlan(seed=0, events=(ReplicaDown(0, 1),)))
    with pytest.raises(ValueError, match="replica"):
        Plan(arch=cfg, serve=_sv(), partition=PartitionSpec(data=2),
             faults=FaultPlan(seed=0, events=(ReplicaDown(5, 1),)))
    # ReplicaDown is a serving fault
    with pytest.raises(ValueError, match="serving fault"):
        Plan(arch=cfg, run=RunSpec(max_waves=1, batch=4, seq=16),
             faults=FaultPlan(seed=0, events=(ReplicaDown(0, 1),)))
    # sample_cluster stays inside the fleet
    fp = FaultPlan.sample_cluster(3, replicas=3)
    (ev,) = fp.of_type(ReplicaDown)
    assert 0 <= ev.replica < 3 and ev.step >= 1
    Plan(arch=cfg, serve=_sv(), partition=PartitionSpec(data=3), faults=fp)


def test_router_rejects_bad_plans():
    cfg = _cfg()
    with pytest.raises(ValueError, match="ServeSpec"):
        Router(Plan(arch=cfg, run=RunSpec(max_waves=1, batch=4, seq=16)),
               **CPU)
    with pytest.raises(ValueError, match="policy"):
        Router(Plan(arch=cfg, serve=_sv()), policy="round_robin", **CPU)
    with pytest.raises(TypeError, match="Plan"):
        Router(object(), **CPU)
    assert set(ROUTER_POLICIES) == {"least_loaded", "deadline"}
    with pytest.raises(ValueError, match="unique"):
        Router(Plan(arch=cfg, serve=_sv()), **CPU).run(
            [Request(rid=0, prompt=np.arange(3))] * 2)


def test_router_runs_on_cuda_unless_asked_for_the_cpu():
    """Without `device` the Router resolves the CUDA card, as Engine does:
    here, without one, it raises and names device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the check is for the CPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Router(Plan(arch=_cfg(), serve=_sv()))


def test_params_are_made_once_and_shared():
    """Every replica Engine serves the Router's one params dict (trap P1):
    the same tensors, in the serve compute dtype, equal to what a
    single-replica Engine makes from the same seed."""
    plan = Plan(arch=_cfg(), partition=PartitionSpec(data=3),
                run=RunSpec(compute_dtype="bfloat16"),
                serve=_sv(replicas=(ReplicaSpec(4), ReplicaSpec(2),
                                    ReplicaSpec(2))))
    router = Router(plan, **CPU)
    for rep in router.replicas:
        rep.engine._ensure_serve()
        assert rep.engine._serve["params"] is router.params
    emb = router.params["embed"]
    assert emb.dtype == torch.bfloat16 and emb.device.type == "cpu"
    single = Engine(plan.replace(partition__data=1, serve__replicas=()),
                    **CPU)
    single._ensure_serve()
    for k, v in router.params["blocks"].items():
        assert torch.equal(v, single._serve["params"]["blocks"][k]), k
    # injected params are taken as they are
    router2 = Router(plan, params=router.params, **CPU)
    assert router2.params is router.params


# ---------------------------------------------------------------------------
# Dispatch invariants
# ---------------------------------------------------------------------------
def test_fifo_no_starvation_under_pressure():
    """More requests than the whole fleet has slots: every request
    retires, none fails, and the merged report covers all rids."""
    plan = Plan(arch=_cfg(), partition=PartitionSpec(data=2),
                serve=_sv(max_batch=2,
                          replicas=(ReplicaSpec(max_batch=2),
                                    ReplicaSpec(max_batch=1))))
    reqs = _reqs(5, 9)
    rep = Router(plan, **CPU).run(reqs)
    assert rep.failed_requests == 0
    assert sorted(s.rid for s in rep.requests) == list(range(9))
    assert rep.tokens_out == sum(r.max_new_tokens for r in reqs)
    assert rep.router["dispatches"] == 9
    assert rep.router["queue_depth_peak"] == 9


def test_affinity_pins_shared_prefix_to_one_replica():
    """Identical page-aligned prefixes land on one replica: its prefix
    index holds the shared pages, every other replica's pool stays
    untouched — zero cross-replica duplicate pages."""
    plan = Plan(arch=_cfg(), partition=PartitionSpec(data=3),
                serve=_sv(share_prefix=True))
    router = Router(plan, **CPU)
    reqs = _reqs(7, 6, shared=6)
    rep = router.run(reqs)
    assert rep.failed_requests == 0
    assert rep.router["affinity_hits"] >= 5      # all but the first
    assert rep.prefix_hit_tokens > 0
    touched = [r.idx for r in router.replicas
               if r.store.peak_pages > 0 or len(r.mm.index.by_page)]
    assert len(touched) == 1, f"shared prefix spread to {touched}"
    owner = router.replicas[touched[0]]
    assert len(owner.mm.index.by_page) > 0


def test_topology_prices_dispatch():
    """A fast-but-far replica loses to a near whimpy one: with the client
    at the ps host (vw0's node) and replica 1 behind the inter-node link,
    ties break toward vw0 and only load pressure pushes traffic across."""
    from repro_torch.dist.topology import ClusterTopology, LinkSpec, Pod
    slow = LinkSpec("far", gbps=0.1, latency_s=5.0)   # absurdly far
    topo = ClusterTopology([Pod("n0", ("vw0",)), Pod("n1", ("vw1",))],
                           inter=slow)
    plan = Plan(arch=_cfg(), partition=PartitionSpec(data=2),
                serve=_sv(max_batch=2,
                          replicas=(ReplicaSpec(max_batch=1),
                                    ReplicaSpec(max_batch=2))))
    router = Router(plan.replace(cluster__topology=topo), **CPU)
    assign = router._dispatch(_reqs(9, 3))
    # replica 0 is whimpy (1 slot) but near: it still wins every request
    # because 5 s of link latency dwarfs any queueing advantage
    assert len(assign[0]) == 3 and len(assign[1]) == 0
    # without the topology the same fleet spreads by load
    flat = Router(plan, **CPU)
    spread = flat._dispatch(_reqs(9, 3))
    assert len(spread[1]) > 0
    # a replica host the topology does not know fails at construction
    with pytest.raises(KeyError):
        Router(plan.replace(cluster__topology=topo, serve__replicas=(
            ReplicaSpec(max_batch=1), ReplicaSpec(host="nowhere"))), **CPU)


def test_deadline_policy_dispatches_by_slack():
    plan = Plan(arch=_cfg(), partition=PartitionSpec(data=2),
                serve=_sv(max_batch=2, replicas=(ReplicaSpec(max_batch=2),
                                                 ReplicaSpec(max_batch=2))))
    router = Router(plan, policy="deadline", **CPU)
    reqs = [Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=2, deadline=100),
            Request(rid=1, prompt=np.arange(4, dtype=np.int32) + 1,
                    max_new_tokens=2, deadline=3)]
    assign = router._dispatch(reqs)
    # the tight-deadline request dispatched first -> emptiest replica (0)
    assert assign[0][0].rid == 1
    for r in router.replicas:
        assert r.scheduler.policy == "deadline"


# ---------------------------------------------------------------------------
# Streams: routing never changes a token stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_router_streams_match_single_replica_oracle(arch):
    """Sampled (temperature 0.7) Router streams equal the port's own
    single-replica Scheduler's: sampling is the port's torch.Generator
    keyed by (sample_seed, rid, k), never jax.random's (trap T2)."""
    cfg = _cfg(arch)
    paged = dict(page_size=4) if arch != "rwkv6-3b" else dict(page_size=0)
    sv = _sv(temperature=0.7, share_prefix=arch == "qwen3-0.6b", **paged)
    reqs = _reqs(11, 6, shared=2)
    plan = Plan(arch=cfg, partition=PartitionSpec(data=2),
                cluster=ClusterSpec(topology="2node"),
                serve=dataclasses.replace(
                    sv, replicas=(ReplicaSpec(max_batch=4),
                                  ReplicaSpec(max_batch=2))))
    got = Router(plan, **CPU).run(_fresh(reqs))
    oracle = Scheduler(Engine(Plan(arch=cfg, serve=sv), **CPU)).run(
        _fresh(reqs))
    assert _streams(got) == _streams(oracle)
    assert got.tokens_out == sum(r.max_new_tokens for r in reqs)


def test_chaos_replica_down_redispatch_no_divergence():
    """Kill one replica mid-decode: unfinished requests re-dispatch to the
    survivor and every stream still matches the single-replica oracle."""
    cfg = _cfg()
    sv = _sv(max_batch=2)
    reqs = _reqs(13, 6)
    plan = Plan(arch=cfg, partition=PartitionSpec(data=2),
                faults=FaultPlan(seed=0, events=(ReplicaDown(1, 1),)),
                serve=sv)
    tr = Tracer()
    rep = Router(plan, tracer=tr, **CPU).run(_fresh(reqs))
    assert rep.router["replica_downs"] == 1
    assert rep.router["rounds"] >= 2           # survivors re-dispatched
    assert rep.router["rebalances"] > 0
    assert rep.failed_requests == 0
    assert sorted(s.rid for s in rep.requests) == list(range(6))
    oracle = Scheduler(Engine(Plan(arch=cfg, serve=sv), **CPU)).run(
        _fresh(reqs))
    assert _streams(rep) == _streams(oracle)
    snap = tr.metrics.snapshot()
    assert snap["counters"]["fault/replica_downs"] == 1
    assert rep.telemetry.counters["fault/replica_downs"] == 1
    # the trace reads like the fleet: replica-scoped scheduler tracks
    tracks = {e[1] for e in tr.events()}
    assert {"router", "r0/sched", "r1/sched"} <= tracks


def test_all_replicas_down_raises():
    plan = Plan(arch=_cfg(), partition=PartitionSpec(data=2),
                faults=FaultPlan(seed=0, events=(ReplicaDown(0, 0),
                                                 ReplicaDown(1, 0))),
                serve=_sv(max_batch=2))
    with pytest.raises(RuntimeError, match="down|no requests|spin"):
        Router(plan, **CPU).run(_reqs(17, 4))


def test_persistent_pools_count_each_round_once():
    """Trap P6: the survivors keep their stores and prefix indexes warm
    across rounds (and across run() calls), so each sub-report carries
    only its own round's memory counters: the merged prefix_hit_tokens,
    pages_shared and cow_copies equal the sums of the sub-reports and the
    replicas' pools' own totals, never counting a round twice."""
    cfg = _cfg()
    # 6-token shared prompts over 4-token pages: the second page is
    # partial, so a full match copies it on write. The pool has room for
    # every prompt's indexed pages: without evict, cold pages the index
    # holds are never reclaimed, and a pool they fill admits nothing
    sv = _sv(prompt_len=8, gen=4, max_batch=2, max_pages=32,
             share_prefix=True)
    rng = np.random.default_rng(23)
    common = rng.integers(0, 256, 6, dtype=np.int32)
    reqs = [Request(rid=i, prompt=common.copy() if i % 2 == 0 else
                    rng.integers(0, 256, 5, dtype=np.int32),
                    max_new_tokens=int(rng.integers(2, 5)))
            for i in range(8)]
    plan = Plan(arch=cfg, partition=PartitionSpec(data=2), serve=sv,
                faults=FaultPlan(seed=0, events=(ReplicaDown(1, 1),)))
    router = Router(plan, **CPU)
    fields = ("prefix_hit_tokens", "pages_shared", "cow_copies")

    def pool_totals():
        return {"prefix_hit_tokens": sum(r.mm.prefix_hit_tokens
                                         for r in router.replicas),
                "pages_shared": sum(r.mm.pages_shared
                                    for r in router.replicas),
                "cow_copies": sum(r.store.cow_copies
                                  for r in router.replicas)}

    first = router.run(_fresh(reqs))
    assert first.router["rounds"] == 2 and first.router["replica_downs"] == 1
    survivor = router.replicas[0]
    subs = [s for s in first.replicas if s.router["replica"] == 0]
    assert len(subs) == 2 and subs[0].prefix_hit_tokens > 0
    for f in fields:
        assert getattr(first, f) == sum(getattr(s, f) for s in
                                        first.replicas) == pool_totals()[f]
    assert first.prefix_hit_tokens > 0 and first.cow_copies > 0
    # a second run on the same fleet: the survivor's index is warm, so
    # even the first shared request hits; only this run's hits count
    before = pool_totals()
    second = router.run(_fresh(reqs))
    after = pool_totals()
    for f in fields:
        assert getattr(second, f) == after[f] - before[f]
    assert second.prefix_hit_tokens > first.prefix_hit_tokens
    assert all(s.router["replica"] == 0 for s in second.replicas)
    assert _streams(second) == _streams(first)
    assert survivor.store.pages_in_use == len(survivor.mm.index.by_page)


def test_scheduler_store_injection_rules():
    eng = Engine(Plan(arch=_cfg(), serve=_sv(share_prefix=True)), **CPU)
    store = eng.serve_store()
    from repro_torch.serve.memory import MemoryManager
    with pytest.raises(ValueError, match="persist together"):
        Scheduler(eng).run(_reqs(3, 2), store=store)
    other = MemoryManager(eng.serve_store(), share_prefix=True)
    with pytest.raises(ValueError, match="different CacheStore"):
        Scheduler(eng).run(_reqs(3, 2), store=store, mm=other)


# ---------------------------------------------------------------------------
# Launch counters under threads (trap P2)
# ---------------------------------------------------------------------------
def test_launch_counts_are_exact_under_threads():
    """kernels._build.count from 8 threads, 10,000 times each, with the
    interpreter switching threads as often as it can: the totals are
    exact (the replicas' threads launch at the same time)."""
    from repro_torch.kernels import _build
    saved = (dict(_build.LAUNCHES),
             {n: dict(r) for n, r in _build.ROUTES.items()})
    interval = sys.getswitchinterval()
    n_threads, n = 8, 10_000
    try:
        sys.setswitchinterval(1e-6)
        _build.reset_launches()
        barrier = threading.Barrier(n_threads)

        def work():
            barrier.wait(timeout=30)
            for _ in range(n):
                _build.count("flash_decode_paged", "tc")
                _build.count("flash_attention_fwd")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _build.LAUNCHES["flash_decode_paged"] == n_threads * n
        assert _build.ROUTES["flash_decode_paged"]["tc"] == n_threads * n
        assert _build.LAUNCHES["flash_attention_fwd"] == n_threads * n
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(saved[0])
        for name, routes in saved[1].items():
            _build.ROUTES[name].update(routes)


# ---------------------------------------------------------------------------
# ServeReport.merge
# ---------------------------------------------------------------------------
def test_merge_degenerate_single_replica():
    """merge([r]) reproduces the single report's derived metrics."""
    plan = Plan(arch=_cfg(), serve=_sv())
    single = Scheduler(Engine(plan, **CPU)).run(_reqs(19, 5))
    merged = ServeReport.merge([single], wall_s=single.wall_s)
    assert merged.occupancy() == pytest.approx(single.occupancy())
    assert merged.page_utilization() == pytest.approx(
        single.page_utilization())
    assert merged.tokens_out == single.tokens_out
    assert merged.tokens_per_s() == pytest.approx(single.tokens_per_s())
    assert _streams(merged) == _streams(single)


def test_merge_weights_capacity_by_decode_steps():
    a = ServeReport(arch="x", backend="threads", max_batch=4,
                    decode_steps=10, slot_steps=20, pages_total=10,
                    peak_pages=5, wall_s=1.0)
    b = ServeReport(arch="x", backend="threads", max_batch=2,
                    decode_steps=5, slot_steps=10, pages_total=4,
                    peak_pages=4, wall_s=2.0)
    m = ServeReport.merge([a, b], router={"policy": "least_loaded"})
    # occupancy = (20+10) / (10*4 + 5*2) = 30/50
    assert m.occupancy() == pytest.approx(30 / 50)
    # page utilization = (5+4) / (10+4)
    assert m.page_utilization() == pytest.approx(9 / 14)
    assert m.wall_s == 2.0                      # replicas ran concurrently
    assert m.router["policy"] == "least_loaded"
    assert (m.max_batch, m.pages_total, m.decode_steps) == (6, 14, 15)
    with pytest.raises(ValueError, match="at least one"):
        ServeReport.merge([])


# ---------------------------------------------------------------------------
# Presets and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["serve_cluster", "serve_shared"])
def test_presets_main_runs_router_and_shared_demos(name, capsys):
    from repro_torch.api import presets
    assert presets.main(["--run", name, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    if name == "serve_cluster":
        assert "replicas=3" in out and "affinity_hits=" in out
        plan = presets.get_preset(name)
        assert plan.partition.data == 3 and len(plan.serve.replicas) == 3
    else:
        assert "prefix_hit=" in out


def test_serve_cli_routes_over_replicas(capsys):
    from repro_torch.launch import serve as cli
    cli.main(["--replicas", "4,2,2", "--topology", "hetero", "--route",
              "deadline", "--chaos", "3", "--device", "cpu", "--requests",
              "8", "--page-size", "4"])
    out = capsys.readouterr().out
    assert "chaos: FaultPlan(seed=3, ReplicaDownx1)" in out
    assert "replicas=4,2,2 route=deadline topology=hetero" in out
    assert "replica_downs=1" in out and "failed=0" in out
    with pytest.raises(SystemExit, match="--requests"):
        cli.main(["--replicas", "2,2", "--device", "cpu"])
    # --chaos without replicas: slot faults through one Scheduler
    cli.main(["--chaos", "1", "--device", "cpu", "--requests", "4",
              "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert "faults: slot_faults=" in capsys.readouterr().out
