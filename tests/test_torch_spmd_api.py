"""The spmd backend through the port's API: the counterparts of the JAX
package's spmd train tests (test_api.py's mesh validation, dropped knobs,
rejoin refusal, presets, repartitioned resume and CLI routing;
test_faults.py's spmd refusal; test_obs.py's spmd wait-seconds), and
spmd_tiny's waves against JAX's Engine(spmd_tiny).fit() from the same
params. On the CPU (device="cpu"), at small sizes."""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import get_preset as j_get_preset
from repro.models import lm as jlm
from repro_torch.api import (BSP, ClusterSpec, Engine, FaultPlan, FaultPolicy,
                             PartitionSpec, Plan, RunSpec, ServeSpec, WSP,
                             WorkerCrash, get_preset, list_presets)
from repro_torch.api.presets import _tiny_arch
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.core import tree as tree_lib
from repro_torch.models import lm
from repro_torch.runtime.checkpoint import latest_checkpoint

CFG = reduced(ARCHS["qwen3-0.6b"], num_layers=2, d_model=32, d_ff=64,
              vocab_size=256, num_heads=2, num_kv_heads=2, head_dim=16,
              num_microbatches=2)
MESH2 = PartitionSpec(stages=2, tp=1, data=1, devices=2)


def test_plan_validates_spmd_mesh():
    with pytest.raises(ValueError, match="arch is required|Plan.arch"):
        Plan(run=RunSpec(backend="spmd"))
    # stages*tp must divide the device count
    with pytest.raises(ValueError, match="does not divide"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"),
             partition=PartitionSpec(stages=2, tp=1, data=1, devices=3))
    with pytest.raises(ValueError, match="data\\*stages\\*tp"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"),
             partition=PartitionSpec(stages=2, tp=1, data=2, devices=8))
    # the pipelined path is D=0 by construction
    with pytest.raises(ValueError, match="D = 0"):
        Plan(arch=CFG, sync=WSP(D=2), run=RunSpec(backend="spmd"),
             partition=MESH2)
    with pytest.raises(ValueError, match="async_push"):
        Plan(arch=CFG, sync=WSP(D=0, async_push=True),
             run=RunSpec(backend="spmd"), partition=MESH2)
    # WSP(D=0) and BSP are accepted; devices_needed defaults to the mesh
    for sync in (WSP(D=0), BSP()):
        plan = Plan(arch=CFG, sync=sync, run=RunSpec(backend="spmd"),
                    partition=PartitionSpec(stages=2, tp=2, data=2))
        assert plan.devices_needed == 8


def test_plan_rejects_knobs_the_spmd_backend_would_drop():
    with pytest.raises(ValueError, match="reduces in-graph"):
        Plan(arch=CFG, run=RunSpec(backend="spmd", codec="int8"),
             partition=MESH2)
    with pytest.raises(ValueError, match="reduces in-graph"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"),
             cluster=ClusterSpec(num_vw=1, topology="2node"),
             partition=MESH2)
    with pytest.raises(ValueError, match="threaded fleet"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"),
             cluster=ClusterSpec(num_vw=2, speeds=(0.0, 0.5)),
             partition=MESH2)
    # the threads backend never factors a mesh
    with pytest.raises(ValueError, match="spmd mesh"):
        Plan(arch=CFG, partition=PartitionSpec(stages=4, data=2))
    # an explicit shape must agree with the run's loader shapes
    with pytest.raises(ValueError, match="disagrees"):
        Plan(arch=CFG, shape=ShapeConfig("x", 128, 8, "train"),
             run=RunSpec(backend="spmd", seq=64, batch=4), partition=MESH2)
    with pytest.raises(ValueError, match="serving shape"):
        Plan(arch=CFG, shape=ShapeConfig("x", 64, 4, "decode"),
             run=RunSpec(backend="spmd", seq=64, batch=4), partition=MESH2)
    Plan(arch=CFG, shape=ShapeConfig("x", 64, 4, "train"),
         run=RunSpec(backend="spmd", seq=64, batch=4), partition=MESH2)


def test_spmd_refuses_faults_and_serving():
    """test_faults.py:87's refusal (no fault seams on spmd), and serving on
    spmd: one replica on the mesh (JAX's refusal of data-parallel serve),
    whose greedy tokens come back from generate()."""
    crash = FaultPlan(events=(WorkerCrash(vw=0, wave=1),))
    with pytest.raises(ValueError, match="spmd"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"), faults=crash,
             partition=MESH2)
    sv = ServeSpec(prompt_len=8, gen=4, max_batch=2)
    with pytest.raises(ValueError, match="data-parallel serve"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"), serve=sv,
             partition=PartitionSpec(stages=2, tp=1, data=2, devices=4))
    plan = Plan(arch=CFG, run=RunSpec(backend="spmd"), serve=sv)
    rep = Engine(plan, device="cpu").generate()
    assert rep.backend == "spmd" and rep.tokens.shape == (2, 4)
    # a policy alone is fine (the spmd backend reads none of it)
    Plan(arch=CFG, run=RunSpec(backend="spmd"), partition=MESH2,
         fault_policy=FaultPolicy(evict_lag=1))


def test_spmd_rejects_rejoin_and_defaults_to_the_card():
    spmd_plan = Plan(arch=CFG, sync=WSP(D=0), partition=MESH2,
                     run=RunSpec(backend="spmd", max_waves=1))
    with pytest.raises(ValueError, match="no workers to rejoin"):
        Engine(spmd_plan, device="cpu").fit(rejoin_failed_after=0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(spmd_plan)


def test_presets_include_spmd_tiny():
    names = set(list_presets())
    assert {"single_node", "paper_hetero", "whimpy_1gbe", "bsp_baseline",
            "spmd_tiny"} <= names
    for name in names:
        assert isinstance(get_preset(name), Plan)
    plan, jplan = get_preset("spmd_tiny"), j_get_preset("spmd_tiny")
    assert plan.describe() == jplan.describe()
    assert plan.run == type(plan.run)(**vars(jplan.run))
    assert plan.devices_needed == jplan.devices_needed == 1


def test_spmd_tiny_losses_equal_jax_wave_by_wave():
    """spmd_tiny's 8 waves from JAX's init params (the ones JAX's Engine
    draws for this Plan): losses within 1e-4 of JAX's, wave by wave."""
    jplan = j_get_preset("spmd_tiny")
    jeng = JEngine(jplan)
    jp, _ = jlm.init_params(jeng._model_arch(),
                            jax.random.PRNGKey(jplan.run.seed))
    jrep = jeng.fit()
    eng = Engine(get_preset("spmd_tiny"), device="cpu",
                 params=lm.params_from_numpy(jax.device_get(jp),
                                             device="cpu"))
    seen = []
    rep = eng.fit(callback=lambda w, loss, dt: seen.append((w, loss)))
    got = [l for _, _, l in rep.losses]
    want = [l for _, _, l in jrep.losses]
    assert rep.waves == jrep.waves == 8
    assert [w for w, _ in seen] == list(range(8))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]
    assert rep.wait_seconds == jrep.wait_seconds == {"spmd": 0.0}
    # the Engine's params are the trained ones, close to JAX's
    want_p = dict(tree_lib.flatten_with_path(jax.device_get(jeng._params)))
    worst = max(float(np.abs(t.numpy() - want_p[p]).max())
                for p, t in tree_lib.flatten_with_path(eng._params))
    assert worst < 1e-3, worst


def test_spmd_step_and_wait_seconds():
    """step() runs one pipelined wave; test_obs.py's spmd case: the spmd
    backend has no sync gate but reports the key."""
    eng = Engine(get_preset("spmd_tiny"), device="cpu")
    l0 = eng.step()
    assert np.isfinite(l0) and eng._spmd["wave"] == 1
    rep = Engine(get_preset("spmd_tiny").replace(run__max_waves=1),
                 device="cpu").fit()
    assert rep.wait_seconds == {"spmd": 0.0}


def test_spmd_pipeline_ticks_are_traced():
    from repro_torch.obs import Tracer
    tracer = Tracer()
    plan = Plan(arch=CFG, partition=PartitionSpec(stages=2, tp=1, data=2),
                sync=WSP(D=0), run=RunSpec(backend="spmd", max_waves=2,
                                           batch=4, seq=16))
    rep = Engine(plan, device="cpu", tracer=tracer).fit()
    assert rep.waves == 2
    ev = tracer.events()
    assert [args["wave"] for ph, tr, name, _, _, args in ev
            if (tr, name) == ("engine", "wave")] == [0, 1]
    # each wave is one measured span: the modeled per-stage ticks (the
    # schedule scaled into the wave, not timed) are no longer rendered
    assert not [tr for ph, tr, *_ in ev if tr.startswith("spmd")]
    assert "pipe/busy_s" not in rep.telemetry.counters


def test_spmd_save_restore_roundtrip():
    plan = Plan(arch=CFG, partition=MESH2, sync=WSP(D=0),
                run=RunSpec(backend="spmd", max_waves=2, batch=4, seq=16))
    with tempfile.TemporaryDirectory() as d:
        eng = Engine(plan, device="cpu")
        eng.fit()
        path = eng.save(d)
        assert path.endswith("step_00000002")
        eng2 = Engine(plan, device="cpu")
        eng2.step()                       # build, then restore over it
        meta = eng2.restore(path)
        assert meta["wave"] == 2
        for (p, a), (_, b) in zip(tree_lib.flatten_with_path(eng._params),
                                  tree_lib.flatten_with_path(eng2._params)):
            assert torch.equal(a, b), p
        assert eng2._spmd["params"] is eng2._params
        # fresh moments for the restored weights
        assert eng2._spmd["opt_state"]["step"] == 0


def test_spmd_resume_with_repartitioned_stages():
    """The spmd backend re-factors stages from the PartitionSpec; the
    resume path builds its checkpoint template from that same arch (padded
    layer counts differ when stages does not divide num_layers)."""
    cfg3 = reduced(ARCHS["qwen3-0.6b"], num_layers=3, d_model=32, d_ff=64,
                   vocab_size=256, num_heads=2, num_kv_heads=2, head_dim=16,
                   num_microbatches=2, stages=2)
    assert cfg3.padded_layers == 4                 # 2 stages pad 3 -> 4
    with tempfile.TemporaryDirectory() as d:
        plan = Plan(arch=cfg3,
                    partition=PartitionSpec(stages=1, tp=1, data=1),
                    sync=WSP(D=0),
                    run=RunSpec(backend="spmd", max_waves=1, batch=4,
                                seq=16, ckpt_dir=d, ckpt_every=1))
        Engine(plan, device="cpu").fit()           # 1-stage arch: 3 layers
        eng2 = Engine(plan.replace(run__resume=True), device="cpu")
        eng2.fit()                                 # restore must not reshape
        assert eng2._step_offset == 1
        assert latest_checkpoint(d).endswith("step_00000002")
        assert eng2._params["blocks"]["wq"].shape[0] == 3


def test_launch_train_spmd_routes_through_engine(capsys):
    from repro_torch.launch import train
    train.main(["--mode", "spmd", "--device", "cpu", "--reduced",
                "--layers", "2", "--d-model", "32", "--waves", "2",
                "--mesh", "1,1,1", "--batch", "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert "mesh=(1,1,1)" in out and "wave " in out
    # the JAX CLI's --devices is accepted and changes nothing
    train.main(["--mode", "spmd", "--device", "cpu", "--reduced",
                "--layers", "2", "--d-model", "32", "--waves", "1",
                "--mesh", "2,2,2", "--devices", "8", "--batch", "8",
                "--seq", "16"])
    cap = capsys.readouterr()
    assert "mesh=(2,2,2) devices=1" in cap.out and "wave    0" in cap.out
    assert "--devices 8 changes nothing" in cap.err
    with pytest.raises(SystemExit, match="threaded WSP runtime"):
        train.main(["--mode", "spmd", "--device", "cpu", "--chaos", "3"])


def test_spmd_engine_params_are_the_trained_ones():
    """No stale copy: after a wave the Engine holds one params tree (the
    step's output), and a params= tree already on the device is used as
    it is, not copied."""
    params = lm.init_params(_tiny_arch(stages=1, tp=1),
                            torch.Generator().manual_seed(0))
    eng = Engine(get_preset("spmd_tiny"), device="cpu", params=params)
    eng._ensure_spmd()
    assert eng._spmd["params"] is params
    before = params["blocks"]["wq"].clone()
    eng.step()
    assert eng._params is eng._spmd["params"]
    assert torch.equal(params["blocks"]["wq"], before)   # not in place
    assert not torch.equal(eng._params["blocks"]["wq"], before)
