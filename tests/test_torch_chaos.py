"""Chaos runs of the port against the JAX package (the counterparts of
tests/test_faults.py's engine, chaos-sweep and serving cases), on the CPU.

Training: seeded FaultPlans through Engine.fit() — the fault digest (every
entry keyed on logical indices, so independent of host timing) equals the
JAX package's for the same plan; the crashed worker is evicted as dead, its
successor finishes waves; the loss tail stays near the fault-free run's;
the traced staleness audit holds D. Serving: SlotFaults through the
Scheduler — requeued streams equal the fault-free ones and the JAX
package's greedy streams, with the same fault counters.
"""
import numpy as np
import pytest

import repro.faults as jf
from repro.api import ClusterSpec as JClusterSpec
from repro.api import Engine as JEngine
from repro.api import Plan as JPlan
from repro.api import RunSpec as JRunSpec
from repro.api import ServeSpec as JServeSpec
from repro.api import WSP as JWSP
from repro.api.serving import Request as JRequest
from repro.api.serving import Scheduler as JScheduler
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro_torch.api import (ClusterSpec, DegradedRunError, Engine, FaultPlan,
                             FaultPolicy, LinkFault, Plan, RunSpec, ServeSpec,
                             SlotFault, WSP, WorkerCrash)
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.obs import Tracer
from test_torch_faults import _to_jax
from test_torch_model import carried_params

SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256, num_heads=2,
             num_kv_heads=2, head_dim=16, num_microbatches=2)
CFG = reduced(ARCHS["qwen3-0.6b"], **SMALL)
J_CFG = j_reduced(J_ARCHS["qwen3-0.6b"], **SMALL)
CHAOS_SEEDS = (3, 5, 11)
POLICY = dict(evict_lag=1, rejoin_after_waves=1, stall_grace_s=5.0)


def _fit(plan, **kw):
    return Engine(plan, device="cpu", **kw)


def _chaos_plan(seed=0, events=(), *, num_vw=3, waves=6, topology=None,
                arch=CFG, **pol):
    kw = dict(POLICY)
    kw.update(pol)
    return Plan(arch=arch,
                cluster=ClusterSpec(num_vw=num_vw, topology=topology,
                                    time_scale=0.001),
                sync=WSP(D=1),
                run=RunSpec(max_waves=waves, batch=4, seq=16),
                faults=FaultPlan(seed=seed, events=tuple(events)),
                fault_policy=FaultPolicy(**kw))


def _jax_fit(plan):
    """The same Plan run by the JAX package (its own init: the digest does
    not depend on the weights)."""
    return JEngine(JPlan(
        arch=J_CFG,
        cluster=JClusterSpec(num_vw=plan.cluster.num_vw,
                             topology=plan.cluster.topology,
                             time_scale=plan.cluster.time_scale),
        sync=JWSP(D=plan.sync.D),
        run=JRunSpec(max_waves=plan.run.max_waves, batch=plan.run.batch,
                     seq=plan.run.seq),
        faults=_to_jax(plan.faults),
        fault_policy=jf.FaultPolicy(**{
            k: getattr(plan.fault_policy, k) for k in (
                "evict_lag", "rejoin_after_waves", "stall_grace_s",
                "max_retries", "allow_degraded")}))).fit()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_unrecovered_transport_death_fails_loudly():
    """A worker whose every push is lost dies with PushTimeout; without a
    successor the run raises DegradedRunError carrying its report, and
    allow_degraded returns that report instead — with JAX's digest."""
    events = (LinkFault(src="vw1", dst="ps", start_msg=0, n_msgs=10_000),)
    plan = _chaos_plan(events=events, num_vw=2, waves=3,
                       rejoin_after_waves=None, max_retries=1)
    with pytest.raises(DegradedRunError, match="did not land") as ei:
        _fit(plan).fit()
    rep = ei.value.report
    assert rep is not None and rep.crashes >= 1 and rep.drops >= 2
    rep2 = _fit(plan.replace(fault_policy__allow_degraded=True)).fit()
    assert rep2.fault_digest() == rep.fault_digest()
    assert rep2.waves_requested == 6 and rep2.waves < 6
    want = _jax_fit(plan.replace(fault_policy__allow_degraded=True))
    assert rep2.fault_digest() == want.fault_digest()


@pytest.fixture(scope="module")
def fault_free_report():
    plan = Plan(arch=CFG, cluster=ClusterSpec(num_vw=3, time_scale=0.001),
                sync=WSP(D=1), run=RunSpec(max_waves=6, batch=4, seq=16))
    return _fit(plan).fit()


def _sampled(seed, arch=CFG):
    return _chaos_plan(seed, FaultPlan.sample_train(
        seed, num_vw=3, max_waves=6).events, arch=arch)


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_digest_equals_the_reference(seed, fault_free_report, tmp_path):
    """FaultPlan.sample_train(seed) run by the port: the digest equals the
    JAX package's for the same plan; the crashed worker is evicted as dead
    and its successor finishes waves; the loss tail is within 20% of the
    fault-free run's; the traced run audits zero violations, staleness max
    <= D, and the summary CLI passes on its trace."""
    from repro_torch.obs.summary import main as summary_main
    tracer = Tracer()
    eng = _fit(_sampled(seed), tracer=tracer)
    rep = eng.fit()
    want = _jax_fit(_sampled(seed))
    assert rep.fault_digest() == want.fault_digest()
    assert rep.crashes >= 1
    assert any(r == "dead" for _, r in rep.fault_digest()["evictions"])
    successor = rep.rejoins[0]
    assert eng.workers[successor].done
    assert eng.workers[successor].metrics.waves > 0

    def tail(r):
        return np.mean([l for _, _, l in r.losses][-3:])
    assert abs(tail(rep) - tail(fault_free_report)) \
        / abs(tail(fault_free_report)) < 0.2
    tel = rep.telemetry
    assert tel.counters.get("wsp/staleness_violations", 0) == 0
    assert tel.staleness_max() is not None and tel.staleness_max() <= 1
    path = tmp_path / "chaos.json"
    tracer.export(str(path))
    assert summary_main([str(path)]) == 0
    # the crashed worker's device state went with it
    dead = [w for w in eng.workers.values() if w.crashed]
    assert dead and all(w.params is None and w.opt_state is None
                        for w in dead)


def test_chaos_digest_independent_of_width():
    """The digest is a function of the plan, not of the model: the same
    seeded plan at two widths gives equal digests (so the card's full-width
    run can be held against a small CPU run)."""
    wide = reduced(ARCHS["qwen3-0.6b"], **dict(SMALL, d_model=64, d_ff=128))
    a = _fit(_sampled(5)).fit().fault_digest()
    b = _fit(_sampled(5, arch=wide)).fit().fault_digest()
    assert a == b and a["rejoins"]


def test_rejoin_traffic_lands_on_failed_nodes_links():
    """The successor is aliased onto the failed worker's topology endpoint,
    so its PS traffic is billed to the failed node's links."""
    eng = _fit(_chaos_plan(events=(WorkerCrash(vw=2, wave=1),),
                           topology="2node"))
    rep = eng.fit()
    assert rep.rejoins == ["vw2r"]
    topo = eng.topology
    assert topo.link("vw2r", "ps").name == topo.link("vw2", "ps").name
    assert eng.workers["vw2r"].metrics.waves > 0
    assert sum(rep.comm.get("bytes_by_link", {}).values()) > 0


# ---------------------------------------------------------------------------
# serving: slot faults, quarantine, requeue/reprefill, shedding
# ---------------------------------------------------------------------------
SERVE_COUNTERS = ("slot_faults", "requeues", "reprefills", "quarantined",
                  "shed", "failed_requests", "prefill_calls",
                  "decode_steps")


@pytest.fixture(scope="module")
def weights():
    return carried_params(J_CFG)


def _serve_plans(events=(), *, max_batch=2, gen=6, prompt_len=8, **pol):
    sv = dict(prompt_len=prompt_len, gen=gen, max_batch=max_batch)
    if not events:
        return Plan(arch=CFG, serve=ServeSpec(**sv)), \
            JPlan(arch=J_CFG, serve=JServeSpec(**sv))
    fp = FaultPlan(events=tuple(events))
    return (Plan(arch=CFG, serve=ServeSpec(**sv), faults=fp,
                 fault_policy=FaultPolicy(**pol)),
            JPlan(arch=J_CFG, serve=JServeSpec(**sv), faults=_to_jax(fp),
                  fault_policy=jf.FaultPolicy(**pol)))


def _prompts(n, prompt_len=8, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, prompt_len, dtype=np.int32)
            for _ in range(n)]


def _serve_both(weights, prompts, *plans):
    jp, tp = weights
    tplan, jplan = plans
    got = Scheduler(Engine(tplan, params=tp, device="cpu")).run(
        [Request(rid=i, prompt=p.copy()) for i, p in enumerate(prompts)])
    want = JScheduler(JEngine(jplan, params=jp)).run(
        [JRequest(rid=i, prompt=p.copy()) for i, p in enumerate(prompts)])
    return got, want


def _same(got, want):
    assert [(r.rid, r.tokens, r.retries, r.shed, r.failed)
            for r in got.requests] == \
        [(r.rid, r.tokens, r.retries, r.shed, r.failed)
         for r in want.requests]
    for f in SERVE_COUNTERS:
        assert getattr(got, f) == getattr(want, f), f


def test_slot_fault_requeue_streams_bit_identical(weights):
    """Under a slot fault every admitted request still emits its fault-free
    stream, which is the JAX package's greedy stream; the counters and the
    fault/* telemetry equal the plan's."""
    prompts = _prompts(4)
    base, jbase = _serve_both(weights, prompts, *_serve_plans())
    _same(base, jbase)
    plans = _serve_plans([SlotFault(slot=0, step=2)])
    tracer = Tracer()
    rep = Scheduler(Engine(plans[0], params=weights[1], device="cpu",
                           tracer=tracer)).run(
        [Request(rid=i, prompt=p.copy()) for i, p in enumerate(prompts)])
    got, want = _serve_both(weights, prompts, *plans)
    _same(got, want)
    assert (rep.slot_faults, rep.requeues, rep.quarantined,
            rep.failed_requests) == (1, 1, 1, 0)
    want_tokens = {r.rid: r.tokens for r in base.requests}
    for r in rep.requests:
        assert r.tokens == want_tokens[r.rid], f"rid {r.rid} diverged"
    assert [r.tokens for r in got.requests] == [r.tokens for r in
                                                rep.requests]
    faulted = [r for r in rep.requests if r.retries]
    assert len(faulted) == 1 and faulted[0].retries == 1
    c = rep.telemetry.counters
    assert (c["fault/slot_faults"], c["fault/requeues"]) == (1, 1)


def test_slot_fault_reprefill_keeps_tokens(weights):
    prompts = _prompts(2, prompt_len=4)
    base, _ = _serve_both(weights, prompts, *_serve_plans(prompt_len=8))
    got, want = _serve_both(weights, prompts, *_serve_plans(
        [SlotFault(slot=0, step=2)], slot_recovery="reprefill",
        quarantine_slots=False))
    _same(got, want)
    assert got.slot_faults == 1
    assert got.reprefills == 1 and got.requeues == 0
    want_tokens = {r.rid: r.tokens for r in base.requests}
    for r in got.requests:
        assert r.tokens == want_tokens[r.rid]


def test_slot_retry_budget_exhaustion_fails_request(weights):
    got, want = _serve_both(weights, _prompts(2), *_serve_plans(
        [SlotFault(slot=0, step=1), SlotFault(slot=0, step=3)],
        max_batch=1, quarantine_slots=False, slot_retry_budget=1))
    _same(got, want)
    assert got.slot_faults == 2 and got.failed_requests == 1
    failed = [r for r in got.requests if r.failed]
    assert len(failed) == 1 and failed[0].retries == 2
    done = [r for r in got.requests if not r.failed and not r.shed]
    assert done and all(r.new_tokens == 6 for r in done)


def test_shed_after_faults_refuses_queue(weights):
    got, want = _serve_both(weights, _prompts(6), *_serve_plans(
        [SlotFault(slot=0, step=1)], shed_after_faults=1))
    _same(got, want)
    assert got.slot_faults == 1 and got.shed >= 1
    shed = [r for r in got.requests if r.shed]
    assert len(shed) == got.shed and all(not r.tokens for r in shed)
    assert sorted(r.rid for r in got.requests) == list(range(6))


def test_stop_serving_aborts_with_the_step(weights):
    """A callback raising StopServing ends the run at that decode step: the
    report holds only what retired, as the JAX package's does."""
    from repro.api.serving import StopServing as JStop
    from repro_torch.api.serving import StopServing

    def stop_at(exc):
        def cb(step, active):
            if step == 3:
                raise exc()
        return cb
    jp, tp = weights
    prompts = _prompts(5)
    tplan, jplan = _serve_plans()
    got = Scheduler(Engine(tplan, params=tp, device="cpu")).run(
        [Request(rid=i, prompt=p.copy()) for i, p in enumerate(prompts)],
        callback=stop_at(StopServing))
    want = JScheduler(JEngine(jplan, params=jp)).run(
        [JRequest(rid=i, prompt=p.copy()) for i, p in enumerate(prompts)],
        callback=stop_at(JStop))
    assert got.aborted_step == want.aborted_step == 3
    assert [(r.rid, r.tokens) for r in got.requests] == \
        [(r.rid, r.tokens) for r in want.requests]


def test_train_cli_chaos_and_summary(capsys, tmp_path):
    """launch/train.py --chaos SEED runs the seeded plan with eviction and
    rejoin and prints its digest; the summary CLI audits its trace. The CLI
    runs the oracle's stall grace (POLICY's 5 s): under the 1 s default a
    loaded box evicts a live worker as stalled (ROADMAP C1)."""
    from repro_torch.launch import train as cli
    from repro_torch.obs.summary import main as summary_main
    path = tmp_path / "chaos.json"
    assert cli.build_parser().parse_args([]).stall_grace_s == 1.0
    cli.main(["--mode", "wsp", "--device", "cpu", "--reduced", "--waves",
              "6", "--num-vw", "3", "--D", "1", "--chaos", "5",
              "--stall-grace-s", str(POLICY["stall_grace_s"]),
              "--time-scale", "0.001", "--trace", str(path)])
    out = capsys.readouterr().out
    digest = _fit(_sampled(5)).fit().fault_digest()
    assert f"faults: {digest}" in out
    assert summary_main([str(path)]) == 0
    assert "bound D=1 -> OK" in capsys.readouterr().out
