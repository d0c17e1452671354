"""The port's Router against the JAX package's, on the CPU in f32.

Both fleets serve the same weights: JAX's init (block matrices scaled so
streams do not repeat one token; RWKV6 also with drawn decay LoRA, mixes
and bonus) handed to the JAX Router through its own `lm.init_params`
(patched for the test: the JAX Router draws its params itself) and to the
port's through `Router(params=)` by `params_from_numpy`. Greedy requests
of the reduced configs of tests/test_router.py go through both: each rid
lands on the same replica, every router counter but the modeled wall, the
merged report's counters and replica-weighted ratios and every stream are
equal (each pick's top-2 margin above the logits' tolerance, trap T3) —
fault-free and with a replica killed at its first decode step.
"""
import numpy as np
import pytest

from repro.api import ClusterSpec as JClusterSpec
from repro.api import FaultPlan as JFaultPlan
from repro.api import PartitionSpec as JPartitionSpec
from repro.api import Plan as JPlan
from repro.api import ReplicaDown as JReplicaDown
from repro.api import ReplicaSpec as JReplicaSpec
from repro.api import ServeSpec as JServeSpec
from repro.api.serving import Request as JRequest
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduced as j_reduced
from repro.models import lm as jlm
from repro.serve.router import Router as JRouter
from repro_torch.api import (ClusterSpec, FaultPlan, PartitionSpec, Plan,
                             ReplicaDown, ReplicaSpec, ServeSpec)
from repro_torch.api.serving import Request, Scheduler
from repro_torch.configs import ARCHS, reduced
from repro_torch.serve.router import Router
from test_torch_model import carried_params as dense_params
from test_torch_rwkv6 import carried_params as rwkv_params

LOGIT_TOL = 1e-4
MERGED = ("tokens_out", "prefill_calls", "decode_steps", "slot_steps",
          "pages_total", "peak_pages", "prefix_hit_tokens", "pages_shared",
          "cow_copies", "failed_requests")


def _cfgs(name):
    base = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=256,
                num_microbatches=2)
    return reduced(ARCHS[name], **base), j_reduced(J_ARCHS[name], **base)


class _MarginScheduler(Scheduler):
    """Records every greedy pick's top-2 logit margin."""

    margins: list

    def _pick_one(self, row, rid, k):
        top = np.partition(np.asarray(row), -2)[-2:]
        self.margins.append(float(top[1] - top[0]))
        return super()._pick_one(row, rid, k)


def _requests(seed, n, *, shared=0, pmax=8, gen=4):
    """(rid, prompt, budget) triples; the first `shared` repeat one full
    prompt (two 4-token pages), the rest are 2..pmax tokens."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 256, pmax, dtype=np.int32)
    return [(i, common.copy() if i < shared else
             rng.integers(0, 256, int(rng.integers(2, pmax + 1)),
                          dtype=np.int32), int(rng.integers(1, gen + 1)))
            for i in range(n)]


def _both(name, seed, n, shared, *, data, batches, topology, page_size,
          faults=None, monkeypatch):
    """The same fleet and requests through JAX's Router and the port's;
    returns (jax report, port report, the port's pick margins)."""
    cfg, jcfg = _cfgs(name)
    jp, tp = (rwkv_params(jcfg)[:2] if name == "rwkv6-3b"
              else dense_params(jcfg))
    monkeypatch.setattr(jlm, "init_params", lambda arch, key: (jp, None))
    share = page_size > 0
    sv = dict(prompt_len=8, gen=4, max_batch=max(batches),
              page_size=page_size, share_prefix=share)
    jplan = JPlan(arch=jcfg, partition=JPartitionSpec(data=data),
                  cluster=JClusterSpec(topology=topology),
                  serve=JServeSpec(**sv, replicas=tuple(
                      JReplicaSpec(max_batch=b) for b in batches)),
                  faults=None if faults is None else JFaultPlan(
                      seed=0, events=(JReplicaDown(*faults),)))
    plan = Plan(arch=cfg, partition=PartitionSpec(data=data),
                cluster=ClusterSpec(topology=topology),
                serve=ServeSpec(**sv, replicas=tuple(
                    ReplicaSpec(max_batch=b) for b in batches)),
                faults=None if faults is None else FaultPlan(
                    seed=0, events=(ReplicaDown(*faults),)))
    reqs = _requests(seed, n, shared=shared)
    want = JRouter(jplan).run([JRequest(i, p.copy(), m) for i, p, m in reqs])
    router = Router(plan, params=tp, device="cpu")
    margins = []
    for rep in router.replicas:
        rep.scheduler = _MarginScheduler(rep.engine,
                                         policy=rep.scheduler.policy)
        rep.scheduler.margins = margins
    got = router.run([Request(i, p.copy(), m) for i, p, m in reqs])
    assert got.tokens_out == sum(m for *_, m in reqs)
    return want, got, margins


def _placement(report):
    """rid -> the replica whose sub-report retired it."""
    return {s.rid: sub.router["replica"] for sub in report.replicas
            for s in sub.requests}


def _assert_same(want, got, margins):
    assert _placement(got) == _placement(want)
    jr = {k: v for k, v in want.router.items() if k != "modeled_fleet_wall_s"}
    tr = {k: v for k, v in got.router.items() if k != "modeled_fleet_wall_s"}
    assert tr == jr
    for f in MERGED:
        assert getattr(got, f) == getattr(want, f), f
    assert got.occupancy() == pytest.approx(want.occupancy())
    assert (got.page_utilization() is None) == \
        (want.page_utilization() is None)
    if want.page_utilization() is not None:
        assert got.page_utilization() == pytest.approx(
            want.page_utilization())
    # per sub-report: the same replica, prefill groups and decode steps
    assert [(s.router["replica"], s.prefill_calls, s.decode_steps,
             s.aborted_step) for s in got.replicas] == \
        [(s.router["replica"], s.prefill_calls, s.decode_steps,
          s.aborted_step) for s in want.replicas]
    assert min(margins) > LOGIT_TOL
    assert [(s.rid, s.tokens) for s in got.requests] == \
        [(s.rid, list(s.tokens)) for s in want.requests]


def test_qwen3_shared_prefix_fleet_matches_reference(monkeypatch):
    """One big + two whimpy replicas behind the 'hetero' topology, half the
    requests sharing a prompt: the same affinity, dispatch and streams."""
    want, got, margins = _both(
        "qwen3-0.6b", 31, 10, 5, data=3, batches=(4, 2, 2),
        topology="hetero", page_size=4, monkeypatch=monkeypatch)
    _assert_same(want, got, margins)
    assert got.router["affinity_hits"] >= 4 and got.prefix_hit_tokens > 0


def test_rwkv6_fleet_matches_reference(monkeypatch):
    """RWKV6 has no page pool: dispatch by queue depth alone, no affinity
    key, per-slot state on each replica."""
    want, got, margins = _both(
        "rwkv6-3b", 37, 8, 0, data=2, batches=(4, 2), topology="2node",
        page_size=0, monkeypatch=monkeypatch)
    _assert_same(want, got, margins)
    assert got.pages_total == 0 and got.page_utilization() is None


def test_replica_down_redispatch_matches_reference(monkeypatch):
    """Replica 1 dies at its first decode step: the same requests replay
    on the survivors, in the same rounds, with the same counters."""
    want, got, margins = _both(
        "qwen3-0.6b", 41, 10, 4, data=3, batches=(4, 2, 2),
        topology="hetero", page_size=4, faults=(1, 1),
        monkeypatch=monkeypatch)
    _assert_same(want, got, margins)
    assert got.router["replica_downs"] == 1 and got.router["rounds"] >= 2
    assert got.router["rebalances"] > 0 and got.failed_requests == 0
