"""The Engine: one facade executing a Plan (the port of repro.api.engine).

fit() dispatches on the Plan alone:

  backend='threads' + WSP/ASP   threaded virtual-worker fleet against the
                                sharded parameter server (true async, D >=
                                0, stragglers, periodic checkpoint, seeded
                                faults under the FleetSupervisor: heartbeat
                                eviction and elastic rejoin)
  backend='threads' + BSP       the synchronous AllReduce loop (ring
                                all-reduce of every wave's deltas,
                                simulated straggler-gated clock)
  backend='spmd'                the pipelined wave step over a (data,
                                stage, tp) mesh (core.wave.build_train_step,
                                D = 0), the mesh's slots wrapping over the
                                Engine's devices (launch.mesh, trap Y1)

step() runs one synchronous wave (of a one-worker fleet on threads, of the
pipelined step on spmd); save()/restore() checkpoint atomically and resume
exactly. Each worker's params, grads, optimizer state and deltas live on
the Engine's device; the parameter server keeps w_global in host memory,
and each wave's deltas and pulls cross in one flat copy
(runtime.staging). Training runs f32 (the JAX threads path never casts,
trap T8).

Serve-mode Plans (Plan.serve = ServeSpec) run with the same dispatch rule.
On the threads backend they run the non-pipelined `lm.forward_ref` cache
path:

  prefill() / decode() / generate()   one aligned batch over the contiguous
                                      cache (with kernel_backend="cuda":
                                      full-attention decode through
                                      flash_decode, RWKV6 prefill through
                                      rwkv6_chunked, SSD prefill through
                                      ssd_chunked)
  prefill_into() / decode(store)      the CacheStore the Scheduler drives
                                      (dense: the paged pool, prefill
                                      through flash_attention_fwd, decode
                                      through flash_decode_paged; RWKV6: no
                                      pool, per-slot WKV state and token
                                      shifts, prefill through rwkv6_chunked,
                                      decode in plain torch; windowed
                                      layers: per-slot kv_win rings, plain
                                      torch; hymba: the pool for its 3 full
                                      layers, rings, per-slot SSD state and
                                      conv tails, prefill through
                                      ssd_chunked)

Stub-frontend archs (chameleon-34b, musicgen-medium) take [B, S, d_model]
embeddings where the others take token ids (models/frontend.py); generate()
draws them, and each decode step's, from a seeded torch.Generator.

Plan.faults injects a seeded FaultPlan through one FaultInjector shared by
the transport, the parameter server, the workers and the Scheduler.

The JAX Engine jit-compiles these steps; here they run eagerly under
torch.inference_mode(), writing the caches in place. Entry points run on
the CUDA card unless the caller passes device="cpu" — then the kernels'
wrappers take their plain PyTorch versions. A fleet of serve replicas is
repro_torch.serve.router's Router, one Engine a replica over one shared
params dict.

On the spmd backend the same surface runs the pipelined serve steps
(core.wave.build_prefill_step / build_decode_step) over a (1, stage, tp)
mesh of slots on the Engine's device: params for the stage-replaced arch
(`_model_arch`), their shard views made once, and every cache placed per
slot (serve.cache.shard_cache; the CacheStore holds one contiguous pool
per (stage, tp) slot). With kernel_backend="cuda" each tp shard of each
microbatch launches the attention kernels at its own heads and rows.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.plan import Plan
from repro_torch.api.report import ServeReport, Telemetry, TrainReport
from repro_torch.api.sync import BSP, WSP
from repro_torch.core import tree as tree_lib
from repro_torch.core.param_server import ParameterServer, host_array
from repro_torch.data.pipeline import MarkovLM, ShardedLoader
from repro_torch.dist import collectives
from repro_torch.dist.topology import make_topology
from repro_torch.dist.transport import NullTransport, SimulatedTransport
from repro_torch.models import frontend, lm
from repro_torch.obs import NULL_TRACER
from repro_torch.obs.metrics import SECONDS_BOUNDS
from repro_torch.runtime.checkpoint import (latest_checkpoint,
                                            load_checkpoint, save_checkpoint)
from repro_torch.runtime.staging import HostStaging, add_, device_tree
from repro_torch.runtime.virtual_worker import VirtualWorker
from repro_torch.serve import cache as cache_lib


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card; without one that raises instead of
    silently running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and torch sees "
                "none; pass device='cpu' to run on the CPU (the kernels' "
                "plain PyTorch versions)")
        return torch.device("cuda")
    return torch.device(device)


#: a trimmed prefill's width is the group's longest prompt rounded up to
#: this: ssd_chunked's chunk, a multiple of rwkv6_chunked's 16; it keeps a
#: row's padding under 64 tokens and the set of widths small
PREFILL_BLOCK = 64


def sample_key(*parts) -> int:
    """A torch.Generator seed from integers, e.g. (sample_seed, rid, k): a
    request's sample stream depends on its own key only, never on its
    co-batched neighbours."""
    h = hashlib.blake2b(repr(tuple(int(p) for p in parts)).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class Engine:
    """Executes a Plan. Model artifacts (params / wave step / optimizer) are
    built from the Plan's ArchConfig by default (params from a
    torch.Generator seeded with run.seed); tests and the legacy shims may
    inject prebuilt ones instead — `lm.params_from_numpy` carries the JAX
    package's weights."""

    def __init__(self, plan: Plan, *, params=None, wave_step=None,
                 optimizer=None, tracer=None, device=None):
        if not isinstance(plan, Plan):
            raise TypeError(f"Engine wants a Plan, got {type(plan).__name__}")
        if plan.arch is None and (params is None or wave_step is None
                                  or optimizer is None):
            raise ValueError("Plan.arch is unset: inject params, wave_step "
                             "and optimizer, or give the Plan an ArchConfig")
        self.plan = plan
        self.device = resolve_device(device)
        # the tracer is runtime state, not Plan state: it cascades into the
        # PS, transport, workers and scheduler this engine builds
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._params = params
        self._wave_step = wave_step
        self._optimizer = optimizer
        self.ps: Optional[ParameterServer] = None
        self.topology = None
        self.workers: dict[str, VirtualWorker] = {}
        self.stop_event = threading.Event()
        self.report: Optional[TrainReport] = None
        self.step_times: dict = {}  # the last step()'s wave / copy / PS secs
        self._source = None
        self._step_ctx = None      # lazy state for step()
        self._serve = None         # lazy state for the serve surface
        self._serve_paged = None   # lazy paged (CacheStore) executors
        self._spmd = None          # lazy state for the spmd backend
        self._step_offset = 0      # waves already in a restored checkpoint
        self._fleet_ran = False    # the threaded fleet is single-shot
        self._bsp_wave = 0         # waves the BSP loop has run (this engine)
        self._injector = None      # the Plan's FaultInjector (lazy)
        self.supervisor = None     # the fleet's FleetSupervisor, if any

    # ------------------------------------------------------------------
    # materialization
    # ------------------------------------------------------------------
    def _model_arch(self):
        """The arch whose parameter shapes this engine trains: the spmd
        backend re-factors stages/tp from the PartitionSpec (the padded
        layer count can change), the threads backend uses the arch as
        declared."""
        plan = self.plan
        if plan.run.backend != "spmd":
            return plan.arch
        arch = dataclasses.replace(plan.arch, stages=plan.stages, tp=plan.tp)
        if plan.partition.num_microbatches:
            arch = dataclasses.replace(
                arch, num_microbatches=plan.partition.num_microbatches)
        return arch

    def _ensure_model(self):
        from repro_torch.core import wave
        from repro_torch.optim import make_optimizer
        plan, run, cfg = self.plan, self.plan.run, self.plan.arch
        if self._optimizer is None:
            self._optimizer = make_optimizer(run.optimizer, run.lr,
                                             run.weight_decay)
        if self._params is None:
            gen = torch.Generator(device=self.device).manual_seed(run.seed)
            self._params = lm.init_params(self._model_arch(), gen,
                                          dtype=torch.float32,
                                          device=self.device)
        if self._wave_step is None and run.backend != "spmd":
            self._wave_step = wave.build_local_wave_step(
                cfg, plan.num_microbatches, self._optimizer)
        if self._source is None:
            self._source = MarkovLM(plan.vocab, seed=run.data_seed)

    def fault_injector(self):
        """The run's FaultInjector, built once from Plan.faults (None when
        the Plan carries no fault scenario). Shared by every seam — the
        transport, the PS, the workers and the Scheduler consult the same
        per-path / per-push / per-step counters."""
        if self._injector is None and self.plan.faults is not None:
            from repro_torch.faults import FaultInjector
            self._injector = FaultInjector(
                self.plan.faults, time_scale=self.plan.cluster.time_scale)
        return self._injector

    def _ensure_ps(self, policy: WSP):
        if self.ps is not None:
            return
        plan = self.plan
        topo = plan.cluster.topology
        if isinstance(topo, str):
            topo = make_topology(topo, plan.cluster.num_vw)
        self.topology = topo
        injector = self.fault_injector()
        fpol = plan.fault_policy
        if topo is not None:
            transport = SimulatedTransport(
                topo, time_scale=plan.cluster.time_scale, tracer=self.tracer,
                injector=injector, policy=fpol)
        elif injector is not None:
            transport = NullTransport(injector=injector, policy=fpol)
        else:
            transport = None
        self.ps = ParameterServer(
            self._params, D=policy.D,
            compression_ratio=plan.run.compression_ratio,
            codec=plan.run.codec, transport=transport, tracer=self.tracer,
            injector=injector)

    def _loader(self, i: int, num_vw: int) -> ShardedLoader:
        run = self.plan.run
        return ShardedLoader(self._source, run.batch, run.seq, i, num_vw,
                             seed=17)

    def attach_telemetry(self, report):
        """Record end-of-run gauges (staleness bound, per-link traffic) and
        attach the metrics snapshot to `report` — no-op untraced."""
        if not self.tracer.enabled:
            return report
        m = self.tracer.metrics
        if isinstance(report, TrainReport):
            if isinstance(self.plan.sync, WSP):
                m.gauge_set("wsp/D", self.plan.sync.D)
            if self.ps is not None:
                stats = self.ps.transport.stats()
                for name, b in stats["bytes_by_link"].items():
                    m.gauge_set(f"link/{name}/bytes", b)
                for name, sec in stats["seconds_by_link"].items():
                    m.gauge_set(f"link/{name}/modeled_s", sec)
        report.telemetry = Telemetry.from_metrics(m)
        return report

    # ------------------------------------------------------------------
    # training surface: fit / step / save / restore
    # ------------------------------------------------------------------
    def fit(self, *, rejoin_failed_after: Optional[float] = None,
            callback: Optional[Callable] = None) -> TrainReport:
        """Run the Plan to completion and return its TrainReport.
        `callback(wave, loss, seconds)` is invoked per wave by the BSP loop;
        the threaded fleet reports at the end."""
        plan = self.plan
        if plan.serve is not None:
            raise ValueError("this Plan describes serving (Plan.serve is "
                             "set); run it through Engine.generate() — "
                             "fit() trains")
        if plan.run.resume and plan.run.ckpt_dir:
            self.restore()
        with self.tracer.span("engine", "fit", backend=plan.run.backend,
                              sync=plan.sync.describe()):
            if plan.run.backend == "spmd":
                if rejoin_failed_after is not None:
                    raise ValueError("elastic rejoin is a feature of the "
                                     "threaded parameter-server fleet; the "
                                     "spmd backend has no workers to "
                                     "rejoin")
                self.report = self._fit_spmd(callback=callback)
            else:
                self.report = plan.sync.execute(
                    self, rejoin_failed_after=rejoin_failed_after,
                    callback=callback)
        return self.attach_telemetry(self.report)

    def step(self) -> float:
        """One synchronous wave: with single-worker semantics (worker vw0
        against the parameter server) on threads, one pipelined wave step
        on spmd. Returns the wave's loss; on threads `step_times` holds its
        wave, D2H, push, pull and H2D seconds."""
        if self.plan.serve is not None:
            raise ValueError("step() drives a training wave; this Plan "
                             "serves — use prefill()/decode()/generate()")
        if self.plan.run.backend == "spmd":
            self._ensure_spmd()
            w = self._spmd["wave"]
            with self.tracer.span("engine", "step", wave=w), \
                    self.tracer.bind("engine", wave=w):
                return self._spmd_step()
        policy = self.plan.sync
        if not isinstance(policy, WSP):
            raise ValueError(
                f"step() drives the parameter-server runtime and supports "
                f"WSP/ASP policies; this Plan's {policy.describe()} runs "
                f"only through fit()")
        self._ensure_model()
        self._ensure_ps(policy)
        if self._step_ctx is None:
            wid = "vw0"
            self.ps.register(wid)
            params = device_tree(self.ps.pull(wid), self.device)
            self._step_ctx = {
                "wid": wid,
                "loader": self._loader(0, 1),
                "params": params,
                "opt_state": self._optimizer.init(params),
                "staging": HostStaging(params, self.device),
            }
        ctx = self._step_ctx
        wid, staging = ctx["wid"], ctx["staging"]
        # raises the typed GateTimeout if the gate never opens
        self.ps.gate(wid, timeout=self.plan.fault_policy.gate_timeout_s)
        times = {}
        with self.tracer.span("engine", "step"):
            t0 = time.monotonic()
            x, y = ctx["loader"].next()
            deltas, ctx["opt_state"], loss = self._wave_step(
                ctx["params"], ctx["opt_state"], x, y)
            loss = float(loss)
            times["wave_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            host = staging.to_host(deltas)
            times["d2h_s"] = staging.d2h_s
            wave = self.ps.push_wave(wid, host)
            times["push_s"] = time.monotonic() - t0
        # mirror VirtualWorker's weight handling so fit() and step() agree:
        # local weights see their own wave immediately, w_global is pulled
        # every pull_every waves
        if policy.pull_every != 1:
            add_(ctx["params"], deltas)
        if policy.pull_every and wave % policy.pull_every == 0:
            t0 = time.monotonic()
            staging.to_device(self.ps.pull(wid), ctx["params"])
            times["pull_s"] = time.monotonic() - t0
            times["h2d_s"] = staging.h2d_s
        self.step_times = times
        return loss

    def save(self, ckpt_dir: Optional[str] = None) -> str:
        """Checkpoint the training state atomically (PS weights + WSP clocks
        are snapshotted under the push lock, so an in-flight async push is
        either entirely in the checkpoint or entirely out)."""
        ckpt_dir = ckpt_dir or self.plan.run.ckpt_dir
        if not ckpt_dir:
            raise ValueError("no checkpoint directory: set run.ckpt_dir or "
                             "pass one to save()")
        if self.ps is not None:
            params, meta = self.ps.checkpoint_state()
            step = min(meta["clocks"].values()) if meta["clocks"] else \
                meta["push_count"]
            return save_checkpoint(ckpt_dir, self._step_offset + step,
                                   {"params": params}, meta)
        if self._spmd is not None:
            step = self._step_offset + self._spmd["wave"]
            return save_checkpoint(ckpt_dir, step,
                                   {"params": self._spmd["params"]},
                                   {"wave": step})
        self._ensure_model()
        step = self._step_offset + self._bsp_wave
        return save_checkpoint(ckpt_dir, step, {"params": self._params},
                               {"wave": step})

    def restore(self, path: Optional[str] = None) -> Optional[dict]:
        """Load the latest (or given) checkpoint's weights into the engine;
        returns the checkpoint meta, or None if there is nothing to restore.
        Worker clocks restart at zero (max_waves counts waves of this run),
        but new checkpoints continue the restored step numbering so a later
        latest_checkpoint() never resolves to pre-resume state."""
        path = path or (latest_checkpoint(self.plan.run.ckpt_dir)
                        if self.plan.run.ckpt_dir else None)
        if path is None:
            return None
        self._ensure_model()
        out, meta = load_checkpoint(path, {"params": self._params})
        self._step_offset = int(meta.get("step", 0))
        self._params = out["params"]
        if self.ps is not None:
            leaves = [host_array(l).astype(np.float32).ravel()
                      for l in tree_lib.leaves(self._params)]
            self.ps.load_state_dict({"flat": leaves,
                                     "clocks": dict(self.ps.clock.state.clocks),
                                     "push_count": self.ps.push_count})
        if self._spmd is not None:
            # the restored weights on the mesh's device, and optimizer
            # moments for them (those of the pre-restore weights go)
            st = self._spmd
            st["params"] = self._params = self._spmd_params()
            st["opt_state"] = self._optimizer.init(st["params"])
        if self._serve is not None:
            st = self._serve
            st["params"] = self._params
            if st["mesh"] is not None:     # the steps' shard views, anew
                st["shards"][0] = lm.shard_blocks(
                    st["cfg"], self._params["blocks"], st["mesh"], 0)
        return meta

    # ------------------------------------------------------------------
    # threads backend: WSP / ASP (policy.execute lands here)
    # ------------------------------------------------------------------
    def _make_worker(self, i: int, wid: str, policy: WSP, *,
                     successor: bool = False) -> VirtualWorker:
        cl = self.plan.cluster
        speeds = cl.speeds or (0.0,) * cl.num_vw
        straggle = cl.straggle_fns or (None,) * cl.num_vw
        injector = self.fault_injector()
        # a rejoined successor does not replay its predecessor's death: the
        # crash / fail_at anchors belong to the original incarnation only
        # (slowdown persists — the *node* is slow, not the process)
        crash_at = None
        if injector is not None and not successor:
            crash_at = injector.crash_wave(i)
        return VirtualWorker(
            wid, self.ps, self._wave_step, self._loader(i, cl.num_vw),
            self._optimizer.init, device=self.device,
            max_waves=self.plan.run.max_waves,
            pull_every=policy.pull_every,
            slowdown=speeds[i], straggle_fn=straggle[i],
            stop_event=self.stop_event,
            fail_at_wave=None if successor else cl.fail_map().get(i),
            async_push=policy.async_push,
            tracer=self.tracer, D=policy.D,
            injector=injector, vw_index=i, crash_at=crash_at,
            gate_timeout_s=self.plan.fault_policy.gate_timeout_s)

    def _fit_threaded(self, policy: WSP, *,
                      rejoin_failed_after: Optional[float] = None,
                      callback: Optional[Callable] = None) -> TrainReport:
        del callback       # per-worker losses are reported at the end
        if self._fleet_ran:
            # a fresh fleet would find the PS clocks already at max_waves
            # and exit with an empty report — fail loudly instead
            raise RuntimeError(
                "this Engine's worker fleet already ran; build a new Engine "
                "(with run.resume=True to continue from a checkpoint)")
        self._fleet_ran = True
        self._ensure_model()
        self._ensure_ps(policy)
        plan, run = self.plan, self.plan.run
        num_vw = plan.cluster.num_vw
        t0 = time.monotonic()
        # register the whole initial fleet before any worker thread runs: a
        # late-registering worker would otherwise start at the already-
        # advanced global clock and silently skip its first waves
        for i in range(num_vw):
            self.ps.register(f"vw{i}")
        for i in range(num_vw):
            wid = f"vw{i}"
            self.workers[wid] = self._make_worker(i, wid, policy)
            self.workers[wid].start()
        ckpt_step = 0
        fpol = plan.fault_policy
        if rejoin_failed_after is not None:
            # the legacy knob, promoted onto the FaultPolicy: rejoin each
            # failed worker once, this many seconds after its eviction
            fpol = dataclasses.replace(
                fpol, rejoin_delay_s=rejoin_failed_after,
                rejoin_max=max(1, fpol.rejoin_max))
        supervise = fpol.evict_lag > 0 or fpol.rejoins \
            or plan.faults is not None
        if supervise:
            from repro_torch.faults import FleetSupervisor

            def spawn(i: int, new_wid: str):
                nw = self._make_worker(i, new_wid, policy, successor=True)
                self.workers[new_wid] = nw
                nw.start()
                return nw

            self.supervisor = FleetSupervisor(
                self.ps, self.workers, fpol, spawn=spawn,
                topology=self.topology, tracer=self.tracer)
        periodic = bool(run.ckpt_dir and run.ckpt_every) or supervise
        if not periodic:
            # nothing to supervise: block on the (fixed) worker set directly
            for w in list(self.workers.values()):
                w.join()
        tick = min(0.25, fpol.heartbeat_every_s) if supervise else 0.25
        while periodic and (
                any(w.is_alive() for w in list(self.workers.values()))
                or (self.supervisor is not None
                    and self.supervisor.pending_rejoin())):
            # wake on wave completion / worker exit rather than busy-polling
            self.ps.push_event.wait(timeout=tick)
            self.ps.push_event.clear()
            if self.supervisor is not None:
                self.supervisor.poll()
            # periodic checkpoint (PS + clocks, snapshotted atomically)
            if run.ckpt_dir and run.ckpt_every:
                gc = self.ps.clock.global_clock()
                if gc >= ckpt_step + run.ckpt_every:
                    ckpt_step = gc
                    params, meta = self.ps.checkpoint_state()
                    save_checkpoint(run.ckpt_dir, self._step_offset + gc,
                                    {"params": params}, meta)
        if run.ckpt_dir and run.ckpt_every:
            # final checkpoint: the loop may exit the moment the last worker
            # dies, before the last periodic write
            gc = self.ps.clock.global_clock()
            if gc > ckpt_step:
                params, meta = self.ps.checkpoint_state()
                save_checkpoint(run.ckpt_dir, self._step_offset + gc,
                                {"params": params}, meta)
        report = TrainReport()
        for wid, w in self.workers.items():
            for t, l in zip(w.metrics.wall_clock, w.metrics.losses):
                report.losses.append((t, wid, l))
            report.waves += w.metrics.waves
            report.overlap_seconds += w.metrics.overlap_seconds
            report.push_wait_seconds += w.metrics.push_wait_seconds
            report.gate_timeouts += w.metrics.gate_timeouts
            if w.failed:
                report.crashes += 1
        report.waves_requested = run.max_waves * num_vw
        report.wall_s = time.monotonic() - t0
        report.wait_seconds = dict(self.ps.clock.wait_seconds)
        report.bytes_pushed = self.ps.bytes_pushed
        report.bytes_wire = self.ps.bytes_wire
        report.comm_seconds = self.ps.comm_seconds
        report.comm = self.ps.transport.stats()
        report.late_pushes = self.ps.late_pushes
        report.ps_stalls = self.ps.ps_stalls
        report.drops = report.comm.get("drops", 0)
        report.retries = report.comm.get("retries", 0)
        if self.supervisor is not None:
            report.evictions = [(e.wid, e.at_clock, e.reason, e.rejoined)
                                for e in self.supervisor.evictions]
            report.rejoins = list(self.supervisor.rejoins)
        # fail loudly on silent degradation: a run that timed out at the
        # staleness gate, or lost a worker to a typed fault without a
        # successor taking over, did NOT do the work the Plan requested.
        # FaultPolicy(allow_degraded=True) opts into getting the (counter-
        # annotated) report back instead.
        if not fpol.allow_degraded:
            degraded = []
            for wid, w in self.workers.items():
                if w.metrics.gate_timeouts:
                    degraded.append(f"{wid}: staleness gate timed out")
                elif w.error is not None and (wid + "r") not in self.workers:
                    degraded.append(f"{wid}: {w.error}")
            if degraded:
                from repro_torch.faults.errors import DegradedRunError
                raise DegradedRunError(
                    "run completed degraded (set FaultPolicy.allow_degraded "
                    "to accept): " + "; ".join(degraded), report=report)
        return report

    # ------------------------------------------------------------------
    # threads backend: BSP (policy.execute lands here)
    # ------------------------------------------------------------------
    def _fit_bsp(self, policy: BSP, *,
                 rejoin_failed_after: Optional[float] = None,
                 callback: Optional[Callable] = None) -> TrainReport:
        """Synchronous AllReduce DP: every wave, all VWs' deltas are reduced
        via an emulated ring all-reduce on the host and applied to one
        global copy on the device.

        Wall clock is a *simulated* straggler-gated time: the VW steps run
        sequentially here, so each wave is charged the max over VWs of
        (measured compute + simulated slowdown) plus the topology-predicted
        all-reduce time, and all of a wave's losses share that one
        timestamp."""
        if rejoin_failed_after is not None:
            raise ValueError("elastic rejoin is a parameter-server feature; "
                             "BSP has no PS to rejoin against")
        self._ensure_model()
        plan, run = self.plan, self.plan.run
        num_vw = plan.cluster.num_vw
        topo = plan.cluster.topology
        if isinstance(topo, str):
            topo = make_topology(topo, num_vw)
        self.topology = topo
        names = [f"vw{i}" for i in range(num_vw)]
        loaders = [self._loader(i, num_vw) for i in range(num_vw)]
        params = device_tree(self._params, self.device)
        opt_states = [self._optimizer.init(params) for _ in range(num_vw)]
        staging = HostStaging(params, self.device)
        mean_dev = tree_lib.tree_map(torch.zeros_like, params)
        speeds = plan.cluster.speeds or (0.0,) * num_vw
        report = TrainReport()
        waits = {f"vw{i}": 0.0 for i in range(num_vw)}
        tr = self.tracer
        sim_t = 0.0
        for wave_i in range(run.max_waves):
            deltas_all, losses, per_vw_t = [], [], []
            t_wave = 0.0
            with tr.span("engine", "bsp_wave", wave=wave_i):
                for i in range(num_vw):
                    x, y = loaders[i].next()
                    tw0 = time.monotonic()
                    with tr.span(f"vw{i}", "wave", wave=wave_i):
                        deltas, opt_states[i], loss = self._wave_step(
                            params, opt_states[i], x, y)
                        loss = float(loss)
                    t_i = time.monotonic() - tw0 + speeds[i]
                    per_vw_t.append(t_i)
                    t_wave = max(t_wave, t_i)
                    # the staging buffers are reused: keep a copy per VW
                    deltas_all.append(tree_lib.tree_map(
                        np.array, staging.to_host(deltas)))
                    losses.append(loss)
                mean_delta, coll_s = collectives.ring_allreduce(
                    deltas_all, topology=topo, workers=names,
                    average=policy.average)
            # the BSP barrier: each VW waits for the wave's slowest
            for i, t_i in enumerate(per_vw_t):
                waits[f"vw{i}"] += t_wave - t_i
                tr.metrics.observe("train/wait_s", t_wave - t_i,
                                   bounds=SECONDS_BOUNDS)
            add_(params, staging.to_device(mean_delta, mean_dev))
            nbytes = sum(np.asarray(l).nbytes
                         for l in tree_lib.leaves(mean_delta))
            report.bytes_pushed += nbytes * num_vw
            # ring wire traffic: each VW moves 2(N-1)/N of the vector per wave
            report.bytes_wire += int(2 * (num_vw - 1) * nbytes) \
                if num_vw > 1 else 0
            report.comm_seconds += coll_s
            sim_t += t_wave + coll_s
            for i, l in enumerate(losses):
                report.losses.append((sim_t, f"vw{i}", l))
            report.waves += num_vw
            if callback is not None:
                callback(wave_i, float(np.mean(losses)), t_wave + coll_s)
            self._params = params
            self._bsp_wave += 1
            if run.ckpt_dir and run.ckpt_every and \
                    ((wave_i + 1) % run.ckpt_every == 0
                     or wave_i + 1 == run.max_waves):
                step = self._step_offset + self._bsp_wave
                save_checkpoint(run.ckpt_dir, step, {"params": params},
                                {"wave": step})
        report.wall_s = sim_t
        report.wait_seconds = waits
        self._params = params
        return report

    # ------------------------------------------------------------------
    # spmd backend: the pipelined wave step (core.wave.build_train_step)
    # ------------------------------------------------------------------
    def _ensure_spmd(self):
        if self._spmd is not None:
            return
        from repro_torch.configs.base import RunConfig, ShapeConfig
        from repro_torch.core import wave

        plan, run = self.plan, self.plan.run
        dsz = plan.partition.data
        mesh = self._mesh(dsz)
        self._ensure_model()           # params for the stage-replaced arch
        shape = plan.shape or ShapeConfig("plan", run.seq, run.batch * dsz,
                                          "train")
        rc = RunConfig(arch=self._model_arch(), shape=shape,
                       optimizer=run.optimizer,
                       lr=run.lr, weight_decay=run.weight_decay,
                       compute_dtype=run.compute_dtype,
                       loss_chunk=min(run.loss_chunk, run.seq),
                       overlap=run.overlap)
        step, _ = wave.build_train_step(rc, mesh)
        self._spmd = {"mesh": mesh, "step": step, "wave": 0,
                      "loader": ShardedLoader(self._source,
                                              shape.global_batch, run.seq,
                                              0, 1)}
        st = self._spmd
        st["params"] = self._params = self._spmd_params()
        st["opt_state"] = self._optimizer.init(st["params"])

    def _mesh(self, data: int):
        """A (data, stages, tp) mesh of slots over this Engine's device:
        the default card means every visible CUDA device, and the slots
        wrap over them (trap Y1), so no device count is refused."""
        from repro_torch.launch.mesh import make_mesh_auto
        devices = None if self.device == torch.device("cuda") \
            else self.device
        return make_mesh_auto((data, self.plan.stages, self.plan.tp),
                              ("data", "stage", "tp"), devices)

    def _spmd_params(self):
        """self._params as f32 tensors on the mesh's first slot's device:
        the same tensors when they are already there, else a copy."""
        dev = self._spmd["mesh"].devices.flat[0]
        leaves = tree_lib.leaves(self._params)
        if all(isinstance(t, torch.Tensor) and t.device == dev
               and t.dtype == torch.float32 for t in leaves):
            return self._params
        return device_tree(self._params, dev)

    def _spmd_step(self) -> float:
        st = self._spmd
        x, y = st["loader"].next()
        st["params"], st["opt_state"], m = st["step"](
            st["params"], st["opt_state"], {"inputs": x, "labels": y})
        # the Engine's params are the trained ones: no stale copy is held
        self._params = st["params"]
        st["wave"] += 1
        return float(m["loss"])

    def _fit_spmd(self, *, callback: Optional[Callable] = None
                  ) -> TrainReport:
        self._ensure_spmd()
        run = self.plan.run
        report = TrainReport()
        t_start = time.monotonic()
        for w in range(run.max_waves):
            t0 = time.monotonic()
            # the pipeline's own spans (`pp_send`) carry the wave
            with self.tracer.span("engine", "wave", wave=w), \
                    self.tracer.bind("engine", wave=w):
                loss = self._spmd_step()      # float(): waits for the wave
            dt = time.monotonic() - t0
            report.losses.append((time.monotonic() - t_start, "spmd", loss))
            report.waves += 1
            if callback is not None:
                callback(w, loss, dt)
            if run.ckpt_dir and run.ckpt_every and \
                    ((w + 1) % run.ckpt_every == 0
                     or w + 1 == run.max_waves):
                # the final wave checkpoints even off-cadence: resume must
                # see the end-of-run state (as the threads backend)
                self.save()
        report.wall_s = time.monotonic() - t_start
        # the wave step has no sync gate; the key keeps one wait_seconds
        # schema across backends
        report.wait_seconds = {"spmd": 0.0}
        return report

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # serve surface
    # ------------------------------------------------------------------
    def _require_serve(self, what: str):
        if self.plan.serve is None:
            raise ValueError(f"{what}() serves requests; Plan.serve is "
                             f"unset — give the Plan a ServeSpec")

    def _ensure_serve(self):
        """Build the serve executors the Plan names: the pipelined mesh
        steps (backend='spmd', core.wave.build_prefill_step /
        build_decode_step over a (1, stage, tp) mesh of this Engine's
        device) or the forward_ref cache path (threads)."""
        if self._serve is not None:
            return
        plan, run, sv = self.plan, self.plan.run, self.plan.serve
        cfg = self._model_arch()
        cdt, cache_dt = cache_lib.serve_dtypes(run.compute_dtype,
                                               sv.cache_dtype)
        if self._params is None:
            gen = torch.Generator(device=self.device).manual_seed(run.seed)
            self._params = lm.init_params(cfg, gen, dtype=cdt,
                                          device=self.device)
        self._serve = {"cfg": cfg, "params": self._params,
                       "cache_dt": cache_dt, "dtype": cdt, "mesh": None}
        if run.backend != "spmd":
            self._serve["prefill"], self._serve["decode"] = \
                _ref_serve_steps(cfg, sv.kernel_backend)
            return
        from repro_torch.core import wave
        mesh = self._serve["mesh"] = self._mesh(1)
        self._serve["shards"] = [lm.shard_blocks(cfg, self._params["blocks"],
                                                 mesh, 0)]
        rc_pre, rc_dec = self._serve_runs(cfg)
        pre, _, _ = wave.build_prefill_step(rc_pre, mesh,
                                            cache_len=sv.max_len)
        dec, _, self._serve["cspecs"] = wave.build_decode_step(
            rc_dec, mesh, pos_per_row=True)
        self._serve["prefill"], self._serve["decode"] = \
            self._spmd_serve_steps(pre, dec, paged=False)

    def _serve_runs(self, cfg):
        """The RunConfigs of the spmd prefill (prompt_len x max_batch) and
        decode (max_len x max_batch) steps."""
        from repro_torch.configs.base import RunConfig, ShapeConfig
        run, sv = self.plan.run, self.plan.serve
        common = dict(arch=cfg, optimizer=run.optimizer, lr=run.lr,
                      weight_decay=run.weight_decay,
                      compute_dtype=run.compute_dtype,
                      cache_dtype=sv.cache_dtype, overlap=run.overlap,
                      kernel_backend=sv.kernel_backend)
        return (RunConfig(shape=ShapeConfig("serve_prefill", sv.prompt_len,
                                            sv.max_batch, "prefill"),
                          **common),
                RunConfig(shape=ShapeConfig("serve_decode", sv.max_len,
                                            sv.max_batch, "decode"),
                          **common))

    def _spmd_serve_steps(self, pre, dec, *, paged: bool):
        """The spmd steps called as the threads ones are (prefill (params,
        prompts[, lens], cache); decode (params, tokens, cache, pos)), over
        the shard views of the params made once in _ensure_serve: the
        params are in the compute dtype already (T8), so a step copies no
        weight."""
        shards = self._serve["shards"]

        def pre_fn(params, prompts, *rest):     # (cache) or (lens, cache)
            batch = {"inputs": prompts, "cache": rest[-1]}
            if paged:
                batch["lens"] = rest[0]
            return pre(params, batch, shards)

        def dec_fn(params, tokens, cache, pos):
            return dec(params, {"inputs": tokens, "cache": cache,
                                "pos": pos}, shards)

        return pre_fn, dec_fn

    def _ensure_serve_store(self):
        if self._serve_paged is not None:
            return
        self._ensure_serve()
        st, sv = self._serve, self.plan.serve
        layout = cache_lib.make_layout(sv.max_batch, sv.max_len,
                                       page_size=sv.page_size,
                                       max_pages=sv.max_pages)
        if st["mesh"] is None:
            pre_fn, dec_fn = _ref_paged_steps(st["cfg"], sv.kernel_backend)
        else:
            from repro_torch.core import wave
            rc_pre, rc_dec = self._serve_runs(st["cfg"])
            pre, _, _ = wave.build_prefill_step(rc_pre, st["mesh"],
                                                layout=layout, var_len=True)
            dec, _, _ = wave.build_decode_step(rc_dec, st["mesh"],
                                               pos_per_row=True,
                                               layout=layout)
            pre_fn, dec_fn = self._spmd_serve_steps(pre, dec, paged=True)
        self._serve_paged = {"layout": layout, "prefill": pre_fn,
                             "decode": dec_fn}

    def serve_store(self) -> cache_lib.CacheStore:
        """A fresh CacheStore (empty page pool) for this Plan's serve
        shapes on this Engine's device (spmd: one pool per mesh slot)."""
        self._require_serve("serve_store")
        self._ensure_serve_store()
        return cache_lib.CacheStore(self._serve["cfg"],
                                    self._serve_paged["layout"],
                                    dtype=self._serve["cache_dt"],
                                    device=self.device,
                                    mesh=self._serve["mesh"])

    def serve_cache(self):
        """A blank contiguous cache for max_batch requests of up to
        serve.max_len positions."""
        self._require_serve("serve_cache")
        self._ensure_serve()
        st, sv = self._serve, self.plan.serve
        cache = cache_lib.init_cache(st["cfg"], sv.max_batch, sv.max_len,
                                     dtype=st["cache_dt"], device=self.device)
        if st["mesh"] is None:
            return cache
        return cache_lib.shard_cache(st["cfg"], cache, st["mesh"],
                                     st["cspecs"])

    def _tokens(self, x, what: str):
        """Token ids, or [B, S, d_model] embeddings (stub-frontend archs,
        cast to the serve compute dtype), on this Engine's device."""
        x = torch.as_tensor(x, device=self.device)
        if self.plan.arch.frontend != "none":
            x = x.to(self._serve["dtype"])
        sv = self.plan.serve
        if what and tuple(x.shape[:2]) != (sv.max_batch, sv.prompt_len):
            raise ValueError(
                f"{what} {tuple(x.shape)} disagree with the frozen serve "
                f"shapes [{sv.max_batch}, {sv.prompt_len}] (pad the batch to "
                f"max_batch and short prompts on the right)")
        return x

    def prefill(self, prompts):
        """Prefill a full batch of prompts into a fresh contiguous cache.

        prompts [max_batch, prompt_len] token ids (or [.., .., d_model]
        embeddings for stub-frontend archs). Returns (last_logits [B, vocab]
        f32, cache)."""
        self._require_serve("prefill")
        self._ensure_serve()
        st, sv = self._serve, self.plan.serve
        prompts = self._tokens(prompts, "prompts")
        cache = self.serve_cache()
        with self.tracer.span("engine", "prefill", batch=sv.max_batch), \
                torch.inference_mode():
            logits, cache = st["prefill"](st["params"], prompts, cache)
            if self.tracer.enabled:      # span measures compute, not enqueue
                self._sync()
        return logits[:, -1], cache

    def _frozen_prefill(self) -> bool:
        """Whether a row's prefill result depends on the call's whole shape,
        so every prefill_into runs at [max_batch, prompt_len]: a
        capacity-routed MoE layer (its capacity counts every position of
        the call, padding included: ROADMAP trap M1) or the spmd step
        (its microbatches split max_batch)."""
        self._ensure_serve()
        return self._serve["mesh"] is not None \
            or self._serve["cfg"].num_experts > 0

    def prefill_shape(self, rows: int, longest: int) -> tuple[int, int]:
        """The [b, s] prompts array a prefill_into call of `rows` prompts,
        the longest `longest` tokens, runs at: [max_batch, prompt_len]
        where the result couples rows (_frozen_prefill), else the rows
        themselves at `longest` rounded up to PREFILL_BLOCK (capped at
        prompt_len). Padded positions are a no-op for the rows' logits,
        pages and per-slot state, so both shapes give each row the same
        result."""
        self._require_serve("prefill_shape")
        sv = self.plan.serve
        if not (1 <= rows <= sv.max_batch and 1 <= longest <= sv.prompt_len):
            raise ValueError(
                f"{rows} rows of up to {longest} tokens outside [1, "
                f"{sv.max_batch}] x [1, {sv.prompt_len}] (ServeSpec)")
        if self._frozen_prefill():
            return sv.max_batch, sv.prompt_len
        return rows, min(sv.prompt_len,
                         -(-longest // PREFILL_BLOCK) * PREFILL_BLOCK)

    def prefill_into(self, store, prompts, lens, slots, skip_pages=None):
        """Prefill a batch of (possibly right-padded) prompts directly into
        `store`'s page pool.

        prompts [b, s] with rows 0..len(slots)-1 carrying real requests: b
        in [len(slots), max_batch] and s in [1, prompt_len], or exactly
        [max_batch, prompt_len] where _frozen_prefill (prefill_shape picks
        the shape); lens [b] per-row prompt lengths; slots the store slot
        of each live row. K/V scatter through the block table in place.
        Returns each row's last-real-position logits [b, vocab].
        skip_pages[j] skips writing row j's first N pages (they hold a
        shared prefix already)."""
        self._require_serve("prefill_into")
        self._ensure_serve_store()
        if not isinstance(store, cache_lib.CacheStore):
            raise TypeError(f"prefill_into writes a CacheStore, got "
                            f"{type(store).__name__}")
        st, pg, sv = self._serve, self._serve_paged, self.plan.serve
        prompts = self._tokens(prompts, "")
        b, s = prompts.shape[:2]
        if self._frozen_prefill():
            if (b, s) != (sv.max_batch, sv.prompt_len):
                raise ValueError(
                    f"prompts {tuple(prompts.shape)} disagree with the "
                    f"frozen prefill shape [{sv.max_batch}, "
                    f"{sv.prompt_len}]: this Plan's rows couple (MoE "
                    f"capacity or the spmd microbatches)")
        elif not (len(slots) <= b <= sv.max_batch
                  and 1 <= s <= sv.prompt_len):
            raise ValueError(
                f"prompts {tuple(prompts.shape)} for {len(slots)} rows "
                f"outside [{len(slots)}..{sv.max_batch}, "
                f"1..{sv.prompt_len}]")
        lens = torch.as_tensor(lens, dtype=torch.int64, device=self.device)
        # the model's own spans (a Mamba-2 layer's `ssd_prefill`) land on
        # the engine track, inside this one
        with self.tracer.span("engine", "prefill", rows=len(slots)), \
                self.tracer.bind("engine"), torch.inference_mode():
            logits, out = pg["prefill"](
                st["params"], prompts, lens,
                store.prefill_input(b, slots, skip_pages=skip_pages))
            store.append_rows(out, [(j, s) for j, s in enumerate(slots)])
            if self.tracer.enabled:
                self._sync()
        # a fresh [b, vocab]: one row sliced from the padded head's logits
        # keeps the pad's row stride, and torch's overlap check then
        # refuses an in-place copy between rows of its clone
        return logits[:, -1].clone(memory_format=torch.contiguous_format)

    def decode(self, tokens, cache, pos):
        """One decode position for the whole batch.

        tokens [B, 1] ids (or [B, 1, d_model] embeddings for stub-frontend
        archs); pos a scalar or [B] vector (each row at its own depth);
        cache the contiguous tree from prefill() — updated in place — or a
        CacheStore, which routes through the paged decode. Returns (logits
        [B, vocab] f32, cache)."""
        self._require_serve("decode")
        self._ensure_serve()
        sv = self.plan.serve
        tokens = self._tokens(tokens, "")
        pos = torch.as_tensor(pos, dtype=torch.int64, device=self.device)
        if pos.dim() == 0:
            pos = pos.expand(sv.max_batch)
        if isinstance(cache, cache_lib.CacheStore):
            self._ensure_serve_store()
            fn, tree = self._serve_paged["decode"], cache.tree
        else:
            self._ensure_serve()
            fn, tree = self._serve["decode"], cache
        tr = self.tracer
        with tr.span("engine", "decode"):
            # issue: the host enqueueing the forward; drain: the device
            # finishing it (the span measures compute, not enqueue)
            with tr.span("engine", "issue"), tr.bind("engine"), \
                    torch.inference_mode():
                logits, out = fn(self._serve["params"], tokens, tree, pos)
            if tr.enabled:
                with tr.span("engine", "drain"):
                    self._sync()
        if isinstance(cache, cache_lib.CacheStore):
            cache.update(out)
            return logits[:, -1], cache
        return logits[:, -1], out

    def _serve_prompts(self):
        """Deterministic synthetic prompts when the caller brings none:
        token ids from a torch.Generator seeded with sample_seed, or stub
        embeddings for frontend archs (not the JAX package's draws)."""
        sv, cfg = self.plan.serve, self.plan.arch
        if cfg.frontend != "none":
            return self._stub_inputs(-1, sv.prompt_len)
        g = torch.Generator().manual_seed(sv.sample_seed)
        return torch.randint(0, cfg.vocab_size, (sv.max_batch, sv.prompt_len),
                             generator=g, dtype=torch.int32)

    def _stub_inputs(self, step: int, seq_len: int):
        """A stub frontend's [max_batch, seq_len, d_model] embeddings for
        decode step `step` (-1: the prompts), drawn on this Engine's device
        from a generator keyed by (sample_seed, step)."""
        sv = self.plan.serve
        g = torch.Generator(device=self.device).manual_seed(
            sample_key(sv.sample_seed, 1, step))
        return frontend.stub_embeddings(self.plan.arch, g, sv.max_batch,
                                        seq_len, dtype=self._serve["dtype"])

    def generate(self, prompts=None, *, callback=None) -> ServeReport:
        """Run the Plan's serve scenario on one aligned batch: prefill
        max_batch prompts, then gen greedy/sampled decode positions over
        the contiguous cache. Returns a ServeReport with `tokens` [B, gen].
        Without prompts they are drawn (`_serve_prompts`). Stub-frontend
        archs feed each decode step a fresh stub embedding, as the JAX
        package does (its frontend would embed the generated id)."""
        self._require_serve("generate")
        self._ensure_serve()
        plan, sv, cfg = self.plan, self.plan.serve, self.plan.arch
        if prompts is None:
            prompts = self._serve_prompts()
        report = ServeReport(arch=cfg.name, backend=plan.run.backend,
                             max_batch=sv.max_batch)
        t_tr = self.tracer.now()
        t_start = time.monotonic()
        logits, cache = self.prefill(prompts)
        self._sync()
        report.prefill_s = time.monotonic() - t_start
        report.prefill_calls = 1
        self.tracer.metrics.observe("serve/ttft_s", report.prefill_s)
        tok = _pick(logits, sv.temperature, sample_key(sv.sample_seed, 0))
        toks = [tok]
        if callback is not None:
            callback(0, tok)
        for t in range(1, sv.gen):
            if cfg.frontend != "none":
                x = self._stub_inputs(t, 1)
            else:
                x = toks[-1][:, None]
            t0 = time.monotonic()
            logits, cache = self.decode(x, cache, sv.prompt_len + t - 1)
            self._sync()
            report.decode_s += time.monotonic() - t0
            report.decode_steps += 1
            tok = _pick(logits, sv.temperature, sample_key(sv.sample_seed, t))
            toks.append(tok)
            if callback is not None:
                callback(t, tok)
        report.tokens = torch.stack(toks, dim=1).cpu().numpy()
        report.wall_s = time.monotonic() - t_start
        self.tracer.add_span("engine", "generate", t_tr, self.tracer.now(),
                             gen=sv.gen, batch=sv.max_batch)
        return self.attach_telemetry(report)


# ---------------------------------------------------------------------------
# serve steps (plain functions; the JAX package jit-compiles its twins)
# ---------------------------------------------------------------------------
def _ref_serve_steps(cfg, kernel_backend="ref"):
    """The non-pipelined forward_ref path over the contiguous cache:
    (prefill_fn, decode_fn). kernel_backend="cuda" routes the attention
    through repro_torch.kernels."""

    def pre_fn(params, prompts, cache):
        hid, cache = lm.forward_ref(cfg, params, prompts, mode="prefill",
                                    cache=cache,
                                    kernel_backend=kernel_backend)
        return lm.logits_ref(cfg, params, hid[:, -1:]), cache

    def dec_fn(params, tokens, cache, pos):
        hid, cache = lm.forward_ref(cfg, params, tokens, mode="decode",
                                    cache=cache, pos=pos,
                                    kernel_backend=kernel_backend)
        return lm.logits_ref(cfg, params, hid), cache

    return pre_fn, dec_fn


def _ref_paged_steps(cfg, kernel_backend="ref"):
    """forward_ref over the paged cache tree: variable-length prefill
    through the block table + per-row-position decode. With the "cuda"
    backend decode walks the block table inside flash_decode_paged."""

    def pre_fn(params, prompts, lens, cache):
        hid, cache = lm.forward_ref(cfg, params, prompts, mode="prefill",
                                    cache=cache, lens=lens,
                                    kernel_backend=kernel_backend)
        idx = (lens - 1).clamp_min(0)
        last = hid[torch.arange(hid.shape[0], device=hid.device), idx]
        return lm.logits_ref(cfg, params, last[:, None]), cache

    dec_fn = _ref_serve_steps(cfg, kernel_backend)[1]
    return pre_fn, dec_fn


def _pick(logits, temperature, seed):
    """Next-token choice over [B, vocab] logits: greedy argmax (first
    index on ties) at temperature 0, else a categorical draw from a
    generator seeded with `seed`."""
    if temperature == 0:
        return logits.argmax(dim=-1).to(torch.int32)
    g = torch.Generator(device=logits.device).manual_seed(seed)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=g)[:, 0].to(torch.int32)
