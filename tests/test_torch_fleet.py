"""The four train presets through Engine.fit() in the port and in the JAX
package, on the same injected weights, on the CPU.

Threaded fleets interleave by host timing, so their loss curves are never
compared point by point (trap T5): each run must pass its staleness audit
(the traced max clock distance at a wave start <= D), learn (the mean of
its last four losses at least 0.7 below its first loss), and end within
0.1 of the JAX run's last-four mean (runs of both packages spread by
about 0.03 from run to run). The BSP loop has no threads: its losses
follow the JAX package's within 1e-3 over 12 waves of SGD at lr 0.3.
"""
import jax
import numpy as np
import pytest

from repro.api import Engine as JEngine
from repro.api import get_preset as j_get_preset
from repro.models import lm as jlm
from repro.obs import Tracer as JTracer
from repro_torch.api import Engine, get_preset, list_presets
from repro_torch.models import lm as tlm
from repro_torch.obs import Tracer

TRAIN_PRESETS = ("single_node", "paper_hetero", "whimpy_1gbe",
                 "bsp_baseline")


def _weights(name):
    jarch = j_get_preset(name).arch
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(0))
    return jp, tlm.params_from_numpy(jax.device_get(jp), device="cpu")


def test_train_presets_build_valid_plans():
    names = set(list_presets())
    assert set(TRAIN_PRESETS) <= names
    for name in TRAIN_PRESETS:
        plan = get_preset(name)
        jplan = j_get_preset(name)
        assert plan.describe() == jplan.describe()
        assert plan.run == type(plan.run)(**vars(jplan.run))
    with pytest.raises(KeyError, match="unknown preset"):
        get_preset("nope")


@pytest.mark.parametrize("name", TRAIN_PRESETS)
def test_train_preset_fit_matches_jax_band(name):
    jp, tp = _weights(name)
    jrep = JEngine(j_get_preset(name), params=jp, tracer=JTracer()).fit()
    tracer = Tracer()
    eng = Engine(get_preset(name), params=tp, tracer=tracer, device="cpu")
    rep = eng.fit()
    plan = get_preset(name)
    assert rep.waves == jrep.waves == plan.run.max_waves * \
        plan.cluster.num_vw
    ys, jys = rep.loss_curve()[1], jrep.loss_curve()[1]
    assert np.all(np.isfinite(ys))
    assert ys[-4:].mean() < ys[0] - 0.7
    assert abs(ys[-4:].mean() - jys[-4:].mean()) < 0.1, (ys[-4:], jys[-4:])
    assert rep.bytes_pushed == jrep.bytes_pushed
    if name == "bsp_baseline":
        np.testing.assert_allclose(ys, jys, rtol=0, atol=1e-3)
        assert rep.bytes_wire == jrep.bytes_wire
        assert rep.comm_seconds == pytest.approx(jrep.comm_seconds)
        return
    # the WSP staleness audit: no wave started more than D ahead
    D = plan.sync.D
    assert rep.telemetry.staleness_max() <= D
    assert "wsp/staleness_violations" not in rep.telemetry.counters
    assert rep.telemetry.gauges["wsp/D"] == D
    assert eng.ps.clock.state.clocks == {
        f"vw{i}": plan.run.max_waves for i in range(plan.cluster.num_vw)}
    if plan.run.codec is not None:
        assert rep.bytes_wire < 0.7 * rep.bytes_pushed
        assert rep.bytes_wire == jrep.bytes_wire
    if plan.cluster.topology is not None:
        assert rep.comm_seconds > 0.0
        assert set(rep.comm["bytes_by_link"]) == \
            set(jrep.comm["bytes_by_link"])
    # every worker's state stayed on the engine's device
    for w in eng.workers.values():
        assert all(t.device.type == "cpu"
                   for t in w.params["blocks"].values())
        assert len(w.metrics.push_s) == plan.run.max_waves
