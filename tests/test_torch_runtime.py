"""The port's threaded multi-VW WSP runtime on the CPU: convergence,
stragglers, elastic fail/rejoin, async push, compression and the simulated
network (the counterparts of test_runtime.py and test_dist.py's trainer
cases). Threaded losses depend on host timing (trap T5): only the one-VW
runs are compared exactly."""
import numpy as np
import pytest
import torch

from repro_torch.api.presets import _tiny_arch
from repro_torch.core.wave import build_local_wave_step
from repro_torch.dist.topology import (ClusterTopology, LinkSpec, NVLINK,
                                       PCIE, Pod)
from repro_torch.models import lm
from repro_torch.optim import make_optimizer
from repro_torch.runtime.trainer import WSPTrainer, bsp_allreduce_baseline

CFG = _tiny_arch()


def _setup(lr=0.3):
    params = lm.init_params(CFG, torch.Generator().manual_seed(0))
    opt = make_optimizer("sgd", lr)
    return params, opt, build_local_wave_step(CFG, CFG.num_microbatches, opt)


def _trainer(**kw):
    params, opt, step = _setup()
    kw.setdefault("vocab", CFG.vocab_size)
    kw.setdefault("seq", 32)
    with pytest.deprecated_call():
        return WSPTrainer(params, step, opt, device="cpu", **kw)


def _final_loss(report, last=8):
    return float(np.mean(report.loss_curve()[1][-last:]))


def test_wsp_trainer_converges():
    tr = _trainer(num_vw=2, D=1, batch=8, max_waves=12)
    rep = tr.run()
    ys = rep.loss_curve()[1]
    assert len(ys) >= 20
    assert _final_loss(rep) < ys[0] - 0.3
    assert rep.bytes_pushed > 0


@pytest.mark.parametrize("D,expect_ahead", [(0, False), (2, True)])
def test_wsp_straggler_d_allows_progress(D, expect_ahead):
    """With a slow VW, D=2 lets the fast VW run ahead; D=0 keeps them in
    lock step."""
    tr = _trainer(num_vw=2, D=D, batch=4, max_waves=8, speeds=[0.0, 0.12])
    tr.run()
    clocks = tr.ps.clock.state.clocks
    if expect_ahead:
        assert tr.ps.clock.wait_seconds["vw0"] < 2.0
    else:
        assert abs(clocks["vw0"] - clocks["vw1"]) <= 1


def test_bsp_baseline_converges():
    params, opt, step = _setup()
    with pytest.deprecated_call():
        rep = bsp_allreduce_baseline(params, step, opt, num_vw=2, batch=8,
                                     seq=32, vocab=CFG.vocab_size,
                                     max_waves=12, device="cpu")
    assert _final_loss(rep) < rep.loss_curve()[1][0] - 0.3


def test_elastic_fail_and_rejoin():
    """vw2 fails (deregisters) at wave 2; 0.2 s later its successor vw2r
    registers at the global clock and trains on."""
    tr = _trainer(num_vw=3, D=1, batch=4, max_waves=8, fail_at={2: 2})
    rep = tr.run(rejoin_failed_after=0.2)
    assert tr.workers["vw2"].failed
    assert tr.ps.clock.state.clocks["vw0"] == 8
    assert tr.ps.clock.state.clocks["vw1"] == 8
    rejoined = [w for k, w in tr.workers.items() if k.endswith("r")]
    assert [w.wid for w in rejoined] == ["vw2r"] == rep.rejoins
    rj = rejoined[0]
    clock = tr.ps.clock.state.clocks.get(rj.wid)
    assert rj.metrics.waves > 0 or clock == 8, (rj.metrics.waves, clock)
    assert rep.crashes == 1
    assert [(w, r) for w, _, r, _ in rep.evictions] == [("vw2", "crashed")]


def test_fail_without_rejoin_leaves_survivors_to_finish():
    tr = _trainer(num_vw=2, D=1, batch=4, max_waves=4, fail_at={1: 1})
    rep = tr.run()
    assert tr.ps.clock.state.clocks == {"vw0": 4}
    assert rep.crashes == 1 and rep.rejoins == []


def test_async_push_matches_blocking_runtime():
    """One VW: the async-push runtime (outbox thread, clock advanced when
    the push lands) reproduces the blocking runtime's clocks, losses and
    final w_global exactly."""
    reps, trs = {}, {}
    for mode in (False, True):
        tr = _trainer(num_vw=1, D=1, batch=4, max_waves=6, pull_every=2,
                      async_push=mode)
        reps[mode] = tr.run()
        trs[mode] = tr
    assert trs[True].ps.clock.state.clocks == \
        trs[False].ps.clock.state.clocks
    assert reps[True].waves == reps[False].waves == 6
    np.testing.assert_array_equal(reps[True].loss_curve()[1],
                                  reps[False].loss_curve()[1])
    for a, b in zip(trs[True].ps.flat, trs[False].ps.flat):
        np.testing.assert_array_equal(a, b)


def test_async_push_multi_vw_converges_and_overlaps():
    slow_eth = LinkSpec("slow-eth", 0.05, 0.01)
    topo = ClusterTopology([Pod("node0", ("vw0",), NVLINK),
                            Pod("node1", ("vw1",), NVLINK)], inter=slow_eth)
    tr = _trainer(num_vw=2, D=2, batch=8, max_waves=12, pull_every=4,
                  topology=topo, time_scale=1.0, speeds=[0.02, 0.02],
                  async_push=True)
    rep = tr.run()
    assert tr.ps.clock.state.clocks == {"vw0": 12, "vw1": 12}
    assert _final_loss(rep) < rep.loss_curve()[1][0] - 0.3
    assert rep.overlap_seconds > 0.0
    assert rep.comm_seconds > 0.0


def test_async_push_respects_staleness_gate():
    tr = _trainer(num_vw=2, D=0, batch=4, max_waves=6, async_push=True,
                  speeds=[0.0, 0.05])
    tr.run()
    assert tr.ps.clock.state.clocks == {"vw0": 6, "vw1": 6}
    assert tr.ps.clock.wait_seconds["vw0"] > 0.1


def test_compression_error_feedback_converges():
    tr = _trainer(num_vw=2, D=0, batch=8, max_waves=12,
                  compression_ratio=0.25)
    rep = tr.run()
    assert _final_loss(rep) < rep.loss_curve()[1][0] - 0.2
    assert rep.bytes_wire < 0.7 * rep.bytes_pushed


def test_trainer_topology_slows_wall_clock():
    kw = dict(num_vw=2, D=0, batch=4, max_waves=3)
    base = _trainer(**kw).run()
    assert base.comm_seconds == 0.0
    slow_eth = LinkSpec("slow-eth", 0.05, 0.05)      # exaggerated for CI
    topo = ClusterTopology([Pod("node0", ("vw0",), NVLINK),
                            Pod("node1", ("vw1",), PCIE)], inter=slow_eth)
    rep = _trainer(topology=topo, **kw).run()
    assert rep.comm_seconds > 0.0
    assert rep.wall_s > base.wall_s
    assert rep.comm["bytes_by_link"].get("slow-eth", 0) > 0


def test_trainer_codec_and_topology_compose():
    rep = _trainer(num_vw=2, D=0, batch=4, max_waves=3, codec="topk:0.25",
                   topology="2node", time_scale=0.0).run()
    assert rep.bytes_wire < rep.bytes_pushed
    assert rep.comm_seconds > 0.0


def test_trainer_rejoin_with_topology_aliases_endpoint():
    tr = _trainer(num_vw=2, D=1, batch=4, max_waves=4, fail_at={1: 1},
                  topology="2node", time_scale=0.0)
    tr.run(rejoin_failed_after=0.05)
    rejoined = [w for k, w in tr.workers.items() if k.endswith("r")]
    assert rejoined and not any(w.failed for w in rejoined)
    assert tr.topology.link("vw1r", "ps").name == \
        tr.topology.link("vw1", "ps").name


def test_bsp_baseline_uses_ring_and_topology():
    params, opt, step = _setup()
    kw = dict(num_vw=2, batch=4, seq=32, vocab=CFG.vocab_size, max_waves=3,
              device="cpu")
    with pytest.deprecated_call():
        rep0 = bsp_allreduce_baseline(params, step, opt, **kw)
        rep1 = bsp_allreduce_baseline(params, step, opt, topology="2node",
                                      **kw)
    assert rep0.comm_seconds == 0.0
    assert rep1.comm_seconds > 0.0
    assert rep1.bytes_wire > 0 and rep1.bytes_pushed > rep1.bytes_wire / 2
    xs, _ = rep1.loss_curve()
    assert (np.diff(xs) >= 0).all()
