"""repro_torch.faults against repro.faults: the seeded plans, the injector's
verdicts, the transport / parameter-server / clock seams, held equal to the
JAX package's on the same inputs (the counterparts of tests/test_faults.py's
validation, injector, transport and PS cases). Pure host code, no model."""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

import repro.faults as jf
from repro.core.param_server import ParameterServer as JParameterServer
from repro.dist.topology import make_topology as j_make_topology
from repro.dist.transport import NullTransport as JNullTransport
from repro.dist.transport import SimulatedTransport as JSimulatedTransport
import repro_torch.faults as tf
from repro_torch.api import (BSP, ClusterSpec, PartitionSpec, Plan, RunSpec,
                             ServeSpec, WSP)
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import tree as tree_lib
from repro_torch.core.param_server import ParameterServer
from repro_torch.core.wsp import WSPClockServer
from repro_torch.dist.topology import make_topology
from repro_torch.dist.transport import NullTransport, SimulatedTransport
from repro_torch.faults import (FaultInjector, FaultPlan, FaultPolicy,
                                GateTimeout, LinkFault, PSStall, PushTimeout,
                                SlotFault, TransportError, WorkerCrash,
                                WorkerSlowdown)

CFG = reduced(ARCHS["qwen3-0.6b"], num_layers=2, d_model=32, d_ff=64,
              vocab_size=256, num_heads=2, num_kv_heads=2, head_dim=16,
              num_microbatches=2)
EVENTS = ("LinkFault", "WorkerCrash", "WorkerSlowdown", "PSStall",
          "SlotFault", "ReplicaDown")


def _to_jax(plan):
    """The same FaultPlan built from repro.faults' event classes."""
    return jf.FaultPlan(seed=plan.seed, events=tuple(
        getattr(jf, type(e).__name__)(**dataclasses.asdict(e))
        for e in plan.events))


# ---------------------------------------------------------------------------
# events, plans, policy
# ---------------------------------------------------------------------------
def test_event_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultPlan(events=(LinkFault(src="a", dst="b", kind="melt"),))
    with pytest.raises(ValueError, match="window"):
        LinkFault(src="a", dst="b", n_msgs=0).validate()
    with pytest.raises(ValueError, match="probability"):
        LinkFault(src="a", dst="b", kind="loss", p=1.5).validate()
    with pytest.raises(ValueError, match="non-negative"):
        WorkerCrash(vw=-1, wave=0).validate()
    with pytest.raises(ValueError, match="non-negative"):
        PSStall(at_push=-1).validate()
    with pytest.raises(TypeError, match="unknown fault event"):
        FaultPlan(events=("not-an-event",))


def test_event_classes_mirror_the_reference():
    """Every event and the policy carry the JAX package's fields and
    defaults; TRAIN_EVENTS / SERVE_EVENTS split them the same way."""
    from repro.faults import plan as jplan
    from repro_torch.faults import plan as tplan
    for name in EVENTS + ("FaultPolicy",):
        a = [(f.name, f.default) for f in
             dataclasses.fields(getattr(jplan, name))]
        b = [(f.name, f.default) for f in
             dataclasses.fields(getattr(tplan, name))]
        assert a == b, name
    assert [c.__name__ for c in tplan.TRAIN_EVENTS] == \
        [c.__name__ for c in jplan.TRAIN_EVENTS]
    assert [c.__name__ for c in tplan.SERVE_EVENTS] == \
        [c.__name__ for c in jplan.SERVE_EVENTS]


@pytest.mark.parametrize("kind", ["train", "serve", "cluster"])
@pytest.mark.parametrize("seed", [0, 3, 5, 11, 42])
def test_sampled_plans_equal_the_reference(kind, seed):
    """FaultPlan.sample_* draws with numpy seeded the same way: a seed gives
    the JAX package's events exactly, and describe() agrees."""
    if kind == "train":
        kw = dict(num_vw=3, max_waves=6)
        a = FaultPlan.sample_train(seed, **kw)
        b = jf.FaultPlan.sample_train(seed, **kw)
        assert FaultPlan.sample_train(seed, with_crash=False, **kw).events \
            == _from_jax(jf.FaultPlan.sample_train(seed, with_crash=False,
                                                   **kw)).events
    elif kind == "serve":
        a = FaultPlan.sample_serve(seed, max_batch=4, n_faults=3)
        b = jf.FaultPlan.sample_serve(seed, max_batch=4, n_faults=3)
    else:
        a = FaultPlan.sample_cluster(seed, replicas=3)
        b = jf.FaultPlan.sample_cluster(seed, replicas=3)
    assert a.events == _from_jax(b).events and a.seed == b.seed
    assert a.describe() == b.describe()


def _from_jax(plan):
    return FaultPlan(seed=plan.seed, events=tuple(
        getattr(tf, type(e).__name__)(**dataclasses.asdict(e))
        for e in plan.events))


def test_policy_validation():
    with pytest.raises(ValueError, match="max_retries"):
        FaultPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="msg_timeout_s"):
        FaultPolicy(msg_timeout_s=-0.1)
    with pytest.raises(ValueError, match="slot_recovery"):
        FaultPolicy(slot_recovery="pray")
    with pytest.raises(ValueError, match="rejoin_after_waves"):
        FaultPolicy(rejoin_after_waves=-1)
    assert not FaultPolicy().rejoins
    assert FaultPolicy(rejoin_after_waves=1).rejoins
    assert FaultPolicy(rejoin_delay_s=0.1).rejoins
    assert not FaultPolicy(rejoin_delay_s=0.1, rejoin_max=0).rejoins


def test_plan_validates_fault_scenarios():
    crash = FaultPlan(events=(WorkerCrash(vw=0, wave=1),))
    # serve plans take SlotFault only; train plans reject it
    with pytest.raises(ValueError, match="this Plan serves"):
        Plan(arch=CFG, serve=ServeSpec(prompt_len=8, gen=4, max_batch=2),
             faults=crash)
    with pytest.raises(ValueError, match="SlotFault is a serving fault"):
        Plan(arch=CFG, faults=FaultPlan(events=(SlotFault(slot=0, step=1),)),
             fault_policy=FaultPolicy(evict_lag=1))
    with pytest.raises(ValueError, match="outside the decode batch"):
        Plan(arch=CFG, serve=ServeSpec(prompt_len=8, gen=4, max_batch=2),
             faults=FaultPlan(events=(SlotFault(slot=5, step=1),)))
    # only the threaded PS runtime has injection seams
    with pytest.raises(ValueError, match="BSP"):
        Plan(arch=CFG, sync=BSP(), faults=crash)
    # the spmd backend has no fault seams (JAX's message)
    with pytest.raises(ValueError, match="spmd"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"), faults=crash,
             partition=PartitionSpec(stages=2, tp=1, data=1, devices=2))
    # event indices must land inside the fleet / run
    with pytest.raises(ValueError, match="outside the fleet"):
        Plan(arch=CFG, cluster=ClusterSpec(num_vw=2),
             faults=FaultPlan(events=(WorkerCrash(vw=7, wave=1),)),
             fault_policy=FaultPolicy(evict_lag=1))
    with pytest.raises(ValueError, match="stops after"):
        Plan(arch=CFG, cluster=ClusterSpec(num_vw=2),
             run=RunSpec(max_waves=3),
             faults=FaultPlan(events=(WorkerSlowdown(vw=1, wave=3),)))
    # a crash in a multi-worker fleet without eviction deadlocks survivors
    with pytest.raises(ValueError, match="evict"):
        Plan(arch=CFG, cluster=ClusterSpec(num_vw=2), faults=crash)
    with pytest.raises(ValueError, match="evict_lag <= max"):
        Plan(arch=CFG, cluster=ClusterSpec(num_vw=2), sync=WSP(D=1),
             faults=crash, fault_policy=FaultPolicy(evict_lag=3))
    with pytest.raises(TypeError, match="fault_policy"):
        Plan(arch=CFG, fault_policy={"evict_lag": 1})


# ---------------------------------------------------------------------------
# injector: deterministic per-attempt verdicts, equal to the reference's
# ---------------------------------------------------------------------------
def test_injector_outage_window_in_attempt_units():
    plan = FaultPlan(events=(
        LinkFault(src="a", dst="b", start_msg=1, n_msgs=2, kind="outage"),))
    inj = FaultInjector(plan)
    assert inj.message_attempts("a", "b", 4) == [(True, 1.0)]
    att = inj.message_attempts("a", "b", 4)
    assert [ok for ok, _ in att] == [False, False, True]
    assert inj.message_attempts("x", "y", 4) == [(True, 1.0)]


@pytest.mark.parametrize("seed", [0, 9, 10])
def test_injector_verdicts_equal_the_reference(seed):
    """Loss, outage and degrade windows on two paths, consumed in the same
    order by both injectors: every verdict sequence is the JAX package's
    (the loss draws hash (seed, crc32(path), attempt) into numpy)."""
    plan = FaultPlan(seed=seed, events=(
        LinkFault(src="a", dst="b", start_msg=0, n_msgs=50, kind="loss",
                  p=0.5),
        LinkFault(src="a", dst="b", start_msg=3, n_msgs=4, kind="degrade",
                  factor=3.0),
        LinkFault(src="vw1", dst="ps", start_msg=2, n_msgs=3,
                  kind="outage"),
        LinkFault(src="vw1", dst="ps", start_msg=0, n_msgs=30, kind="loss",
                  p=0.3)))
    ti, ji = FaultInjector(plan), jf.FaultInjector(_to_jax(plan))
    for i in range(16):
        path = ("a", "b") if i % 3 else ("vw1", "ps")
        assert ti.message_attempts(*path, 6) == ji.message_attempts(*path, 6)
    # a different seed reshuffles the loss draws
    other = FaultInjector(FaultPlan(seed=seed + 1, events=plan.events))
    fresh = FaultInjector(plan)
    assert [other.message_attempts("a", "b", 6) for _ in range(12)] != \
        [fresh.message_attempts("a", "b", 6) for _ in range(12)]


def test_injector_worker_and_ps_seams():
    plan = FaultPlan(events=(
        WorkerCrash(vw=1, wave=3), WorkerCrash(vw=1, wave=5),
        WorkerSlowdown(vw=2, wave=2, extra_s=0.4),
        PSStall(at_push=4, seconds=0.5),
        SlotFault(slot=1, step=2), SlotFault(slot=0, step=2),
    ))
    inj = FaultInjector(plan, time_scale=0.1)
    ref = jf.FaultInjector(_to_jax(plan), time_scale=0.1)
    assert inj.crash_wave(1) == 3          # earliest crash wins
    assert inj.crash_wave(0) is None
    assert inj.slowdown_extra(2, 2) == pytest.approx(0.04)   # scaled
    assert inj.ps_stall_sleep(4) == pytest.approx(0.05)      # scaled
    for vw in range(3):
        assert inj.crash_wave(vw) == ref.crash_wave(vw)
        for w in range(4):
            assert inj.slowdown_extra(vw, w) == ref.slowdown_extra(vw, w)
    for p in range(6):
        assert inj.ps_stall_sleep(p) == ref.ps_stall_sleep(p)
    for st in range(4):
        assert inj.slot_faults(st) == ref.slot_faults(st)
    assert not inj.empty and FaultInjector(None).empty


# ---------------------------------------------------------------------------
# transport: retry/backoff, per-link accounting, typed exhaustion
# ---------------------------------------------------------------------------
def _stats_pair(make, events, sends, **pol):
    """Run the same sends through the port's and the JAX package's
    transport built by make(module_ns): both stats() dicts."""
    out = []
    for ns in ("torch", "jax"):
        plan = FaultPlan(events=events)
        if ns == "torch":
            inj = FaultInjector(plan)
            tr = make(NullTransport, SimulatedTransport, make_topology, inj,
                      FaultPolicy(**pol))
        else:
            inj = jf.FaultInjector(_to_jax(plan))
            tr = make(JNullTransport, JSimulatedTransport, j_make_topology,
                      inj, jf.FaultPolicy(**pol))
        for src, dst, n in sends:
            try:
                tr.send(src, dst, n)
            except (TransportError, jf.TransportError) as e:
                assert type(e).__name__ == "TransportError"
        out.append(tr.stats())
    return out


def test_simulated_transport_retries_and_accounts():
    topo = make_topology("2node", 4)
    inj = FaultInjector(FaultPlan(events=(
        LinkFault(src="vw2", dst="ps", start_msg=0, n_msgs=2),)))
    tr = SimulatedTransport(topo, time_scale=0.0, injector=inj,
                            policy=FaultPolicy(max_retries=3))
    sec = tr.send("vw2", "ps", 1000)
    s = tr.stats()
    assert s["drops_by_link"]["eth10"] == 2
    assert s["retries_by_link"]["eth10"] == 2
    assert s["drops"] == 2 and s["retries"] == 2
    assert s["seconds_by_link"]["eth10"] > 0 and sec > 0
    before = s["seconds_by_link"]["eth10"]
    tr.send("vw2", "ps", 1000)
    s2 = tr.stats()
    assert s2["drops"] == 2 and s2["seconds_by_link"]["eth10"] > before


@pytest.mark.parametrize("simulated", [True, False], ids=["sim", "null"])
def test_transport_accounting_equals_the_reference(simulated):
    """Drops, retries, bytes and modeled seconds (timeouts + capped
    exponential backoff + degraded link cost) per link equal the JAX
    package's for the same messages, exhaustion included."""
    events = (LinkFault(src="vw2", dst="ps", start_msg=1, n_msgs=3),
              LinkFault(src="vw0", dst="ps", start_msg=0, n_msgs=40,
                        kind="loss", p=0.6),
              LinkFault(src="ps", dst="vw1", start_msg=0, n_msgs=2,
                        kind="degrade", factor=4.0),
              LinkFault(src="vw3", dst="ps", start_msg=0, n_msgs=99))
    sends = [(s, d, 1000 + 10 * i) for i, (s, d) in enumerate(
        [("vw2", "ps"), ("vw2", "ps"), ("vw0", "ps"), ("ps", "vw1"),
         ("vw0", "ps"), ("vw3", "ps"), ("ps", "vw1"), ("vw0", "ps"),
         ("vw2", "ps"), ("vw1", "ps")])]

    def make(null, sim, topo, inj, pol):
        if simulated:
            return sim(topo("2node", 4), time_scale=0.0, injector=inj,
                       policy=pol)
        return null(injector=inj, policy=pol)
    got, want = _stats_pair(make, events, sends, max_retries=3)
    assert got == want
    assert got["drops"] > 0 and got["retries"] > 0


def test_simulated_transport_exhaustion_raises_typed():
    topo = make_topology("2node", 4)
    inj = FaultInjector(FaultPlan(events=(
        LinkFault(src="vw2", dst="ps", start_msg=0, n_msgs=100),)))
    tr = SimulatedTransport(topo, time_scale=0.0, injector=inj,
                            policy=FaultPolicy(max_retries=2))
    h = tr.send_async("vw2", "ps", 500)
    with pytest.raises(TransportError, match="vw2->ps"):
        h.wait()
    with pytest.raises(TransportError):       # every waiter sees it
        h.wait()
    assert tr.stats()["drops_by_link"]["eth10"] == 3    # 1 + max_retries


def test_null_transport_fault_path():
    inj = FaultInjector(FaultPlan(events=(
        LinkFault(src="a", dst="b", start_msg=0, n_msgs=1),)))
    tr = NullTransport(injector=inj)
    tr.send("a", "b", 10)               # one retry, then lands
    assert tr.stats()["drops_by_link"]["loopback"] == 1
    tr2 = NullTransport(
        injector=FaultInjector(FaultPlan(events=(
            LinkFault(src="a", dst="b", start_msg=0, n_msgs=9),))),
        policy=FaultPolicy(max_retries=0))
    with pytest.raises(TransportError):
        tr2.send("a", "b", 10)


# ---------------------------------------------------------------------------
# WSP clock + PS: typed gate, late pushes, push timeouts, stalls
# ---------------------------------------------------------------------------
def _tiny_ps(cls=ParameterServer, **kw):
    return cls({"w": np.zeros(8, np.float32)}, num_shards=2, **kw)


def test_clock_wait_reason_disambiguates():
    clk = WSPClockServer(D=0)
    clk.register("a")
    clk.register("b")
    clk.complete_wave("a")
    assert clk.wait_reason("a", timeout=0.05) == "timeout"
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault("r", clk.wait_reason("a", timeout=5.0)))
    t.start()
    time.sleep(0.05)
    clk.deregister("a")
    t.join(5.0)
    assert out["r"] == "evicted"
    assert clk.complete_wave_if_registered("a") is None
    assert clk.complete_wave_if_registered("b") == 1


def test_ps_gate_raises_gate_timeout():
    ps = _tiny_ps(D=0)
    ps.register("a")
    ps.register("b")
    ps.push_wave("a", {"w": np.ones(8, np.float32)})
    with pytest.raises(GateTimeout, match="staleness gate"):
        ps.gate("a", timeout=0.05)
    assert ps.gate("b", timeout=0.05) is True


def test_ps_gate_returns_false_for_evicted():
    ps = _tiny_ps(D=0)
    ps.register("a")
    ps.register("b")
    ps.push_wave("a", {"w": np.ones(8, np.float32)})
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault("r", ps.gate("a", timeout=5.0)))
    t.start()
    time.sleep(0.05)
    ps.deregister("a")
    t.join(5.0)
    assert out["r"] is False


def test_late_push_after_deregister_never_advances_clock():
    """An evicted worker's in-flight push applies its delta but never moves
    the global clock past what the survivors gated against — as in the
    JAX package, whose server ends in the same state."""
    states = []
    for cls in (ParameterServer, JParameterServer):
        ps = _tiny_ps(cls, D=4)
        ps.register("a")
        ps.register("b")
        pending = ps.begin_push("a", {"w": np.ones(8, np.float32)})
        ps.deregister("a")
        assert ps.finish_push(pending) == -1
        assert ps.late_pushes == 1 and ps.clock.global_clock() == 0
        assert "a" not in ps.clock.state.clocks
        got = ps.pull()
        leaf = tree_lib.leaves(got)[0] if cls is ParameterServer else \
            jax.tree.leaves(got)[0]
        states.append(np.asarray(leaf).copy())
    np.testing.assert_array_equal(states[0], states[1])
    assert np.allclose(states[0], 1.0)


def test_push_timeout_is_typed():
    for cls, inj, pol, null in (
            (ParameterServer, FaultInjector, FaultPolicy, NullTransport),
            (JParameterServer, jf.FaultInjector, jf.FaultPolicy,
             JNullTransport)):
        ev = (jf if cls is JParameterServer else tf).LinkFault(
            src="a", dst="ps", start_msg=0, n_msgs=50)
        plan = (jf if cls is JParameterServer else tf).FaultPlan(
            events=(ev,))
        ps = _tiny_ps(cls, D=2, transport=null(
            injector=inj(plan), policy=pol(max_retries=1)))
        ps.register("a")
        with pytest.raises(Exception, match="did not land") as ei:
            ps.push_wave("a", {"w": np.ones(8, np.float32)})
        assert type(ei.value).__name__ == "PushTimeout"
        assert ps.push_count == 0 and ps.clock.state.clocks["a"] == 0
    assert issubclass(PushTimeout, tf.FaultError)


def test_ps_stall_lands_on_its_push_number():
    """PSStall(at_push=k) sleeps before applying push k, on both sides; the
    port counts it in ps_stalls and the fault/ps_stalls counter."""
    from repro_torch.obs import Tracer
    plan = FaultPlan(events=(PSStall(at_push=2, seconds=0.2),))
    tr = Tracer()
    ps = _tiny_ps(D=8, injector=FaultInjector(plan), tracer=tr)
    jps = _tiny_ps(JParameterServer, D=8,
                   injector=jf.FaultInjector(_to_jax(plan)))
    for p in (ps, jps):
        p.register("a")
    times = []
    for _ in range(4):
        t0 = time.monotonic()
        ps.push_wave("a", {"w": np.ones(8, np.float32)})
        times.append(time.monotonic() - t0)
        jps.push_wave("a", {"w": np.ones(8, np.float32)})
    assert ps.ps_stalls == jps.ps_stalls == 1
    assert times[2] >= 0.2 and times[2] == max(times)
    assert tr.metrics.snapshot()["counters"]["fault/ps_stalls"] == 1
