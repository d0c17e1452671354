"""The port's training surface: Plan validation, SyncPolicy dispatch,
Engine.fit()/step()/save()/restore(), checkpoints (an exact round trip, and
cross-loads with the JAX package in both directions), and the train CLI
(the counterparts of test_api.py's train half)."""
import os
import tempfile
import types

import jax
import numpy as np
import pytest
import torch

from repro.api.presets import _tiny_arch as j_tiny_arch
from repro.models import lm as jlm
from repro.optim import make_optimizer as j_make_optimizer
from repro.runtime import checkpoint as jckpt
from repro_torch.api import (ASP, BSP, ClusterSpec, Engine, FaultPlan,
                             FaultPolicy, LinkFault, PartitionSpec, Plan,
                             PSStall, ReplicaDown, RunSpec, ServeSpec,
                             TrainReport, UNBOUNDED_D, WSP, WorkerCrash,
                             get_preset)
from repro_torch.api.presets import _tiny_arch
from repro_torch.core import tree as tree_lib
from repro_torch.core.wave import build_local_wave_step
from repro_torch.models import lm
from repro_torch.optim import make_optimizer
from repro_torch.runtime.checkpoint import (latest_checkpoint,
                                            load_checkpoint, save_checkpoint)

CFG = _tiny_arch()


def _setup(lr=0.3):
    params = lm.init_params(CFG, torch.Generator().manual_seed(0))
    opt = make_optimizer("sgd", lr)
    return params, opt, build_local_wave_step(CFG, CFG.num_microbatches, opt)


def _engine(plan, **kw):
    if "params" not in kw:
        kw["params"], kw["optimizer"], kw["wave_step"] = _setup()
    return Engine(plan, device="cpu", **kw)


def _unit_step(params, opt_state, x, y):
    return {"w": np.ones(4, np.float32)}, opt_state, 1.0


_UNIT_OPT = types.SimpleNamespace(init=lambda p: None)


# -- Plan -------------------------------------------------------------------

def test_plan_validates_at_construction():
    with pytest.raises(ValueError, match="D must be"):
        Plan(sync=WSP(D=-1))
    with pytest.raises(ValueError, match="pull_every"):
        Plan(sync=WSP(pull_every=0))
    with pytest.raises(ValueError, match="num_vw"):
        Plan(cluster=ClusterSpec(num_vw=0))
    with pytest.raises(ValueError, match="speeds has"):
        Plan(cluster=ClusterSpec(num_vw=2, speeds=(0.1,)))
    with pytest.raises(ValueError, match="unknown backend"):
        Plan(run=RunSpec(backend="mpi"))
    with pytest.raises(ValueError, match="two spellings"):
        Plan(run=RunSpec(codec="int8", compression_ratio=0.5))
    with pytest.raises(ValueError, match="unknown codec"):
        Plan(run=RunSpec(codec="zstd"))
    with pytest.raises(ValueError, match="topology"):
        Plan(cluster=ClusterSpec(num_vw=2, topology="bogus-spec"))
    with pytest.raises(ValueError, match="not divisible"):
        Plan(arch=CFG, run=RunSpec(batch=5))
    with pytest.raises(ValueError, match="outside the fleet"):
        Plan(cluster=ClusterSpec(num_vw=2, fail_at={5: 3}))
    with pytest.raises(ValueError, match="compression_ratio"):
        Plan(run=RunSpec(compression_ratio=1.5))


def test_plan_rejects_knobs_the_backend_would_drop():
    with pytest.raises(ValueError, match="BSP loop all-reduces"):
        Plan(sync=BSP(), run=RunSpec(codec="topk:0.25"))
    with pytest.raises(ValueError, match="speeds only"):
        Plan(sync=BSP(), cluster=ClusterSpec(num_vw=2, fail_at={0: 1}))
    with pytest.raises(ValueError, match="spmd mesh"):
        Plan(arch=CFG, partition=PartitionSpec(stages=4, data=2))
    # the spmd backend trains and serves (its mesh validated as JAX's);
    # the host-level knobs are refused on both
    plan = Plan(arch=CFG, run=RunSpec(backend="spmd"))
    assert (plan.stages, plan.tp, plan.devices_needed) == (CFG.stages, 1, 2)
    with pytest.raises(ValueError, match="reduces in-graph"):
        Plan(arch=CFG, run=RunSpec(backend="spmd", codec="int8"))
    sv = ServeSpec(prompt_len=8, gen=4, max_batch=2)
    assert "backend=spmd" in Plan(arch=CFG, run=RunSpec(backend="spmd"),
                                  serve=sv).describe()
    with pytest.raises(ValueError, match="reduces in-graph"):
        Plan(arch=CFG, run=RunSpec(backend="spmd"), serve=sv,
             cluster=ClusterSpec(topology="2node"))
    # a FaultPlan is accepted (validated against the Plan), a stand-in is
    # refused by type, and the serving-only ReplicaDown needs a fleet with
    # a survivor (and is refused on a train Plan)
    plan = Plan(arch=CFG, cluster=ClusterSpec(num_vw=2),
                faults=FaultPlan(seed=3, events=(
                    WorkerCrash(vw=1, wave=1), PSStall(at_push=0),
                    LinkFault(src="vw0", dst="ps", kind="loss"))),
                fault_policy=FaultPolicy(evict_lag=1))
    assert plan.faults.describe() == \
        "FaultPlan(seed=3, LinkFaultx1, PSStallx1, WorkerCrashx1)"
    with pytest.raises(TypeError, match="FaultPlan"):
        Plan(arch=CFG, faults=object())
    with pytest.raises(ValueError, match="survivor"):
        Plan(arch=CFG, serve=ServeSpec(),
             faults=FaultPlan(events=(ReplicaDown(replica=1, step=1),)))
    with pytest.raises(ValueError, match="serving fault"):
        Plan(arch=CFG, faults=FaultPlan(events=(ReplicaDown(1, 1),)))


def test_plan_replace_asp_and_loss_curve():
    plan = Plan(arch=CFG, sync=WSP(D=1))
    p2 = plan.replace(sync__D=3, run__max_waves=7,
                      cluster=ClusterSpec(num_vw=4))
    assert (p2.sync.D, p2.run.max_waves, p2.cluster.num_vw) == (3, 7, 4)
    assert plan.sync.D == 1
    assert isinstance(ASP(), WSP) and ASP().D == UNBOUNDED_D
    assert "inf" in ASP().describe()
    rep = TrainReport(losses=[(1.0, "vw9", 3.0), (1.0, 2, 4.0),
                              (0.5, "vw1", 5.0)])
    xs, ys = rep.loss_curve()
    assert list(xs) == [0.5, 1.0, 1.0] and list(ys) == [5.0, 3.0, 4.0]
    assert rep.losses_by_worker()["vw9"] == [3.0]


# -- Engine -------------------------------------------------------------------

def test_engine_requires_arch_or_injection_and_a_device():
    with pytest.raises(ValueError, match="inject"):
        Engine(Plan(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(get_preset("single_node"))


def test_fit_and_step_refuse_serve_plans():
    """fit() on a serve Plan raises the JAX package's ValueError."""
    eng = Engine(get_preset("serve_tiny"), device="cpu")
    with pytest.raises(ValueError, match="describes serving"):
        eng.fit()
    with pytest.raises(ValueError, match="serves"):
        eng.step()


def test_engine_matches_legacy_wsp_trainer_and_bsp():
    from repro_torch.runtime.trainer import (WSPTrainer,
                                             bsp_allreduce_baseline)
    params, opt, step = _setup()
    plan = Plan(cluster=ClusterSpec(num_vw=1), sync=WSP(D=1, pull_every=2),
                run=RunSpec(max_waves=6, batch=8, seq=32,
                            vocab=CFG.vocab_size))
    eng = _engine(plan, params=params, wave_step=step, optimizer=opt)
    rep_new = eng.fit()
    with pytest.deprecated_call():
        tr = WSPTrainer(params, step, opt, num_vw=1, D=1, pull_every=2,
                        batch=8, seq=32, vocab=CFG.vocab_size, max_waves=6,
                        device="cpu")
    np.testing.assert_array_equal(rep_new.loss_curve()[1],
                                  tr.run().loss_curve()[1])
    for a, b in zip(eng.ps.flat, tr.ps.flat):
        np.testing.assert_array_equal(a, b)
    bplan = Plan(cluster=ClusterSpec(num_vw=2), sync=BSP(),
                 run=RunSpec(max_waves=3, batch=8, seq=32,
                             vocab=CFG.vocab_size))
    rep_b = _engine(bplan, params=params, wave_step=step,
                    optimizer=opt).fit()
    with pytest.deprecated_call():
        rep_old = bsp_allreduce_baseline(params, step, opt, num_vw=2,
                                         batch=8, seq=32,
                                         vocab=CFG.vocab_size, max_waves=3,
                                         device="cpu")
    np.testing.assert_array_equal(rep_b.loss_curve()[1],
                                  rep_old.loss_curve()[1])


def test_threads_fit_is_single_shot_and_bsp_rejects_rejoin():
    plan = Plan(cluster=ClusterSpec(num_vw=1), sync=WSP(D=1),
                run=RunSpec(max_waves=2, batch=8, seq=32,
                            vocab=CFG.vocab_size))
    eng = _engine(plan)
    eng.fit()
    with pytest.raises(RuntimeError, match="already ran"):
        eng.fit()
    bplan = plan.replace(sync=BSP(), cluster=ClusterSpec(num_vw=2))
    with pytest.raises(ValueError, match="no PS"):
        _engine(bplan).fit(rejoin_failed_after=0.1)


def test_asp_fast_worker_never_gated():
    plan = Plan(cluster=ClusterSpec(num_vw=2, speeds=(0.0, 0.08)),
                sync=ASP(),
                run=RunSpec(max_waves=4, batch=4, seq=32,
                            vocab=CFG.vocab_size))
    rep = _engine(plan).fit()
    assert rep.wait_seconds["vw0"] < 0.05


def test_step_matches_fit_including_pull_every():
    """step() x 4 reproduces fit()'s loss sequence and final w_global
    exactly on one worker, pull_every 2 included."""
    params, opt, step = _setup()
    plan = Plan(cluster=ClusterSpec(num_vw=1), sync=WSP(D=1, pull_every=2),
                run=RunSpec(max_waves=4, batch=8, seq=32,
                            vocab=CFG.vocab_size))
    eng_fit = _engine(plan, params=params, wave_step=step, optimizer=opt)
    rep = eng_fit.fit()
    eng_step = _engine(plan, params=params, wave_step=step, optimizer=opt)
    losses = [eng_step.step() for _ in range(4)]
    assert all(isinstance(l, float) for l in losses)
    np.testing.assert_array_equal(np.asarray(losses), rep.loss_curve()[1])
    for a, b in zip(eng_step.ps.flat, eng_fit.ps.flat):
        np.testing.assert_array_equal(a, b)
    assert eng_step.ps.clock.state.clocks == {"vw0": 4}
    with pytest.raises(ValueError, match="fit"):
        _engine(plan.replace(sync=BSP(), cluster=ClusterSpec(num_vw=2))
                ).step()


def test_preset_override_and_run():
    plan = get_preset("single_node", run__max_waves=4, sync__D=0)
    assert plan.run.max_waves == 4 and plan.sync.D == 0
    rep = Engine(plan, device="cpu").fit()
    assert rep.waves == 8


def test_fit_raises_degraded_on_gate_timeout(monkeypatch):
    """A worker whose gate never opens (its peer stopped without saying
    goodbye) fails the run loudly with DegradedRunError."""
    from repro_torch.faults.errors import DegradedRunError
    plan = Plan(cluster=ClusterSpec(num_vw=2, speeds=(0.0, 2.0)),
                sync=WSP(D=0), run=RunSpec(max_waves=2, batch=2, seq=8,
                                           vocab=16),
                fault_policy=FaultPolicy(gate_timeout_s=0.3))
    eng = _engine(plan, params={"w": np.zeros(4, np.float32)},
                  wave_step=_unit_step, optimizer=_UNIT_OPT)
    with pytest.raises(DegradedRunError, match="staleness gate") as ei:
        eng.fit()
    assert ei.value.report.gate_timeouts >= 1


# -- checkpoints ----------------------------------------------------------

def test_checkpoint_roundtrip_exact():
    params = lm.init_params(CFG, torch.Generator().manual_seed(1))
    opt = make_optimizer("adamw", 1e-3)
    state = opt.init(params)
    state["m"]["embed"] += 0.5
    state["step"] = 3
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 3, {"params": params, "opt": state},
                               {"note": "t"})
        assert latest_checkpoint(d) == path
        out, meta = load_checkpoint(path, {"params": params, "opt": state})
        assert meta["step"] == 3 and meta["note"] == "t"
        assert out["opt"]["step"] == 3
        for a, b in zip(tree_lib.leaves(out), tree_lib.leaves(
                {"params": params, "opt": state})):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype
                assert torch.equal(a, b)


def test_checkpoints_cross_load_with_jax():
    """A checkpoint the JAX package wrote (params and an adamw state)
    restores in the port bit for bit, and one the port wrote restores in
    the JAX package: the same leaf paths, the same files."""
    jarch = j_tiny_arch()
    jp, _ = jlm.init_params(jarch, jax.random.PRNGKey(3))
    jst = j_make_optimizer("adamw", 1e-3).init(jp)
    tp = lm.params_from_numpy(jax.device_get(jp), device="cpu")
    tst = make_optimizer("adamw", 1e-3).init(tp)
    with tempfile.TemporaryDirectory() as d:
        path = jckpt.save_checkpoint(d, 5, {"params": jp, "opt": jst},
                                     {"clocks": {"vw0": 5}})
        zeros = tree_lib.tree_map(torch.zeros_like, tp)
        out, meta = load_checkpoint(path, {"params": zeros, "opt": tst})
        assert meta == {"step": 5, "clocks": {"vw0": 5}}
        for a, b in zip(tree_lib.leaves(out["params"]),
                        jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert out["opt"]["step"] == 0
        trained = tree_lib.tree_map(lambda t: t + 0.25, tp)
        path2 = save_checkpoint(d, 6, {"params": trained}, {"wave": 6})
        assert jckpt.latest_checkpoint(d) == path2
        jout, jmeta = jckpt.load_checkpoint(path2, {"params": jp})
        assert jmeta["step"] == 6
        for a, b in zip(jax.tree.leaves(jout["params"]),
                        tree_lib.leaves(trained)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_engine_save_restore_roundtrip():
    params, opt, step = _setup()
    with tempfile.TemporaryDirectory() as d:
        plan = Plan(cluster=ClusterSpec(num_vw=1), sync=WSP(D=1),
                    run=RunSpec(max_waves=3, batch=8, seq=32,
                                vocab=CFG.vocab_size, ckpt_dir=d))
        eng = _engine(plan, params=params, wave_step=step, optimizer=opt)
        eng.fit()
        path = eng.save()
        trained = [f.copy() for f in eng.ps.flat]
        eng2 = _engine(plan, params=params, wave_step=step, optimizer=opt)
        meta = eng2.restore(path)
        assert meta["clocks"] == {"vw0": 3}
        eng2._ensure_ps(plan.sync)
        for a, b in zip(eng2.ps.flat, trained):
            np.testing.assert_array_equal(a, b)
        assert all(isinstance(t, torch.Tensor)
                   for t in tree_lib.leaves(eng2._params))


def test_bsp_checkpoints_and_resumes():
    with tempfile.TemporaryDirectory() as d:
        plan = Plan(cluster=ClusterSpec(num_vw=2), sync=BSP(),
                    run=RunSpec(max_waves=3, batch=2, seq=8, vocab=16,
                                ckpt_dir=d, ckpt_every=2))
        kw = dict(wave_step=_unit_step, optimizer=_UNIT_OPT)
        _engine(plan, params={"w": np.zeros(4, np.float32)}, **kw).fit()
        assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
        _engine(plan.replace(run__resume=True, run__max_waves=2),
                params={"w": np.zeros(4, np.float32)}, **kw).fit()
        out, meta = load_checkpoint(latest_checkpoint(d),
                                    {"params": {"w": np.zeros(4)}})
        assert meta["step"] == 5
        np.testing.assert_array_equal(out["params"]["w"], np.full(4, 5.0))
        eng = _engine(plan.replace(run__resume=True, run__max_waves=1,
                                   run__ckpt_every=0),
                      params={"w": np.zeros(4, np.float32)}, **kw)
        eng.fit()
        assert eng.save().endswith("step_00000006")


def test_checkpoint_not_lost_or_doubled_under_async_push():
    """Periodic checkpoints taken while async outbox pushes are in flight
    hold weights == push_count * unit delta, and a resume continues
    exactly."""
    from repro_torch.dist.topology import ClusterTopology, LinkSpec, NVLINK
    from repro_torch.dist.topology import Pod
    slow = LinkSpec("slow", 1e6, 0.02)
    topo = ClusterTopology([Pod("node0", ("vw0",), NVLINK),
                            Pod("node1", ("vw1",), NVLINK)], inter=slow)

    def unit_step(params, opt_state, x, y):
        return {"w": np.ones(8, np.float32)}, opt_state, 1.0

    with tempfile.TemporaryDirectory() as d:
        plan = Plan(cluster=ClusterSpec(num_vw=2, topology=topo,
                                        time_scale=1.0),
                    sync=WSP(D=4, pull_every=2, async_push=True),
                    run=RunSpec(max_waves=6, batch=2, seq=8, vocab=16,
                                ckpt_dir=d, ckpt_every=1))
        kw = dict(wave_step=unit_step, optimizer=_UNIT_OPT)
        _engine(plan, params={"w": np.zeros(8, np.float32)}, **kw).fit()
        steps = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        assert steps
        for s in steps:
            out, meta = load_checkpoint(os.path.join(d, s),
                                        {"params": {"w": np.zeros(8)}})
            np.testing.assert_array_equal(
                out["params"]["w"], np.full(8, float(meta["push_count"])))
        eng2 = _engine(plan.replace(run__max_waves=2, run__resume=True,
                                    run__ckpt_every=0),
                       params={"w": np.zeros(8, np.float32)}, **kw)
        eng2.fit()
        _, meta = load_checkpoint(latest_checkpoint(d),
                                  {"params": {"w": np.zeros(8)}})
        np.testing.assert_array_equal(
            eng2.ps.flat[0],
            np.full(8, float(meta["push_count"]) + 4.0, np.float32))


def test_resume_checkpoint_numbering_monotone():
    with tempfile.TemporaryDirectory() as d:
        plan = Plan(cluster=ClusterSpec(num_vw=1), sync=WSP(D=1),
                    run=RunSpec(max_waves=3, batch=2, seq=8, vocab=16,
                                ckpt_dir=d, ckpt_every=1))
        kw = dict(wave_step=_unit_step, optimizer=_UNIT_OPT)
        _engine(plan, params={"w": np.zeros(4, np.float32)}, **kw).fit()
        first = latest_checkpoint(d)
        _engine(plan.replace(run__resume=True, run__max_waves=2),
                params={"w": np.zeros(4, np.float32)}, **kw).fit()
        assert latest_checkpoint(d) > first
        for s in sorted(os.listdir(d)):
            out, _ = load_checkpoint(os.path.join(d, s),
                                     {"params": {"w": np.zeros(4)}})
            np.testing.assert_array_equal(
                out["params"]["w"], np.full(4, float(s.removeprefix(
                    "step_"))))


# -- CLI ------------------------------------------------------------------

def test_launch_train_wsp_routes_through_engine(capsys):
    from repro_torch.launch import train
    a = train.build_parser().parse_args([])
    assert a.device == "cuda" and a.reduced is False and a.mode == "wsp"
    train.main(["--mode", "wsp", "--device", "cpu", "--reduced",
                "--layers", "2", "--d-model", "32", "--waves", "2",
                "--num-vw", "1", "--D", "0", "--batch", "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert "waves=2" in out and "last_loss=" in out and "push_ms=" in out
    train.main(["--topology", "list"])
    assert "<k>node[:LINK]" in capsys.readouterr().out
    # --mode spmd trains through the pipelined Engine, and refuses --chaos
    # as the JAX CLI does
    with pytest.raises(SystemExit, match="threaded WSP runtime"):
        train.main(["--mode", "spmd", "--device", "cpu", "--chaos", "5"])
    train.main(["--mode", "spmd", "--device", "cpu", "--reduced",
                "--layers", "2", "--d-model", "32", "--waves", "1",
                "--mesh", "1,2,1", "--batch", "4", "--seq", "16"])
    assert "mesh=(1,2,1) devices=1" in capsys.readouterr().out
