"""Declarative experiment Plans (the port of repro.api.plan).

    Plan = ArchConfig x ClusterSpec x PartitionSpec x SyncPolicy x RunSpec
           [x ServeSpec]

A Plan is the single description of a training OR serving scenario. It is
frozen and validated at construction, so a malformed scenario fails where
it is written, not three layers down inside a worker thread. The port runs
both on the threads backend: Engine.fit()/step() train, and
`serve=ServeSpec(...)` turns the Plan into a serving scenario for
Engine.prefill()/decode()/generate(). `faults=FaultPlan(...)` and
`fault_policy=FaultPolicy(...)` attach a seeded fault scenario and its
recovery posture (repro_torch.faults), validated against the Plan they
ride. A serve Plan with `partition.data` > 1 is a fleet of replicas
(`ServeSpec.replicas` sizes each one) run by repro_torch.serve.router's
Router, its dispatch priced by `cluster.topology`. `run.backend="spmd"`
trains through the pipelined wave step (core.wave.build_train_step) over a
(data, stage, tp) mesh factored by the PartitionSpec, at WSP(D=0) or BSP,
and serves through the pipelined prefill / decode steps
(core.wave.build_prefill_step / build_decode_step) over a (1, stage, tp)
mesh: one replica, its batch whole on the mesh.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.api.sync import BSP, SyncPolicy, WSP
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.compression import make_codec
from repro_torch.dist.topology import make_topology
from repro_torch.faults.plan import (FaultPlan, FaultPolicy, SERVE_EVENTS,
                                     TRAIN_EVENTS, ReplicaDown, SlotFault,
                                     WorkerCrash, WorkerSlowdown)
from repro_torch.kernels.ops import BACKENDS


@dataclass(frozen=True)
class ClusterSpec:
    """The fleet: how many virtual workers, on what (modeled) network, with
    what simulated heterogeneity."""

    num_vw: int = 1
    # a repro_torch.dist.topology.ClusterTopology, a spec string for
    # make_topology ('single', '2node:ib', 'hetero', 'paper', ...) or None
    # for the zero-latency default
    topology: Any = None
    speeds: Optional[tuple] = None          # per-VW extra seconds/wave
    straggle_fns: Optional[tuple] = None    # per-VW wave -> extra seconds
    fail_at: tuple = ()                     # ((vw_index, wave), ...) failures
    time_scale: float = 1.0                 # scale modeled delays into sleeps

    def __post_init__(self):
        if self.speeds is not None:
            object.__setattr__(self, "speeds", tuple(self.speeds))
        if self.straggle_fns is not None:
            object.__setattr__(self, "straggle_fns",
                               tuple(self.straggle_fns))
        if isinstance(self.fail_at, dict):
            object.__setattr__(self, "fail_at",
                               tuple(sorted(self.fail_at.items())))
        else:
            object.__setattr__(self, "fail_at", tuple(self.fail_at))

    def fail_map(self) -> dict:
        return dict(self.fail_at)


@dataclass(frozen=True)
class PartitionSpec:
    """Mesh/pipeline factorization. Zeros defer to the ArchConfig."""

    stages: int = 0             # 0 -> arch.stages
    tp: int = 0                 # 0 -> arch.tp
    data: int = 1               # data-parallel width (serve: Router replicas)
    num_microbatches: int = 0   # 0 -> arch.num_microbatches
    devices: int = 0            # expected device count (0 -> data*stages*tp)


@dataclass(frozen=True)
class RunSpec:
    """Everything about one run that is neither model, fleet nor sync."""

    backend: str = "threads"    # threads (host-level) | spmd (pipelined)
    max_waves: int = 20
    batch: int = 8              # per-VW wave batch
    seq: int = 64
    vocab: int = 0              # 0 -> arch.vocab_size
    optimizer: str = "sgd"
    lr: float = 0.3
    weight_decay: float = 0.1
    seed: int = 0               # parameter init seed
    data_seed: int = 0
    codec: Optional[str] = None
    compression_ratio: Optional[float] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    resume: bool = False
    overlap: bool = False
    compute_dtype: str = "float32"
    loss_chunk: int = 512


@dataclass(frozen=True)
class ReplicaSpec:
    """One replica's sizing in a data-parallel serve fleet
    (`partition.data` > 1, routed by `repro_torch.serve.router.Router`).

    Zeros defer to the cluster-level ServeSpec, whose `max_batch` /
    `max_pages` are the per-replica *ceiling*: a whimpy replica shrinks
    them (fewer decode slots, a smaller KV page pool) and the Router
    steers short-prompt / short-deadline traffic its way. `host` names
    the replica's endpoint in `cluster.topology` (default "vw{i}") so
    dispatch can price the client->replica link."""

    max_batch: int = 0          # decode slots; 0 -> ServeSpec.max_batch
    max_pages: int = 0          # KV page pool; 0 -> ServeSpec.max_pages
    host: str = ""              # topology endpoint; "" -> "vw{index}"


@dataclass(frozen=True)
class ServeSpec:
    """Frozen serving shapes and sampling for a serve-mode Plan.

    Batched prefill over `max_batch` prompts of up to `prompt_len` tokens,
    then up to `gen` decode positions against `max_len = prompt_len + gen`
    logical slots. temperature 0 is greedy argmax; > 0 samples from a
    torch.Generator keyed by (sample_seed, request, step).

    The Scheduler's full-attention KV lives in a paged pool
    (repro_torch.serve.cache): `page_size` tokens per page (0 -> max_len)
    from a pool of `max_pages` pages (0 -> the worst case); admission is
    refused while the pool is exhausted. `share_prefix` / `evict` /
    `preempt` drive repro_torch.serve.memory. `kernel_backend` picks the
    plain attention and WKV paths ("ref") or the Hopper kernels ("cuda")."""

    prompt_len: int = 24
    gen: int = 16
    max_batch: int = 4
    temperature: float = 0.0
    sample_seed: int = 0
    cache_dtype: str = ""           # "" -> run.compute_dtype; "f8" -> fp8 KV
    page_size: int = 0              # KV page tokens; 0 -> max_len (1 pg/slot)
    max_pages: int = 0              # pool size; 0 -> worst-case B * pages/slot
    share_prefix: bool = False      # refcounted prefix sharing + CoW
    evict: bool = False             # LRU-evict cold indexed pages
    preempt: bool = False           # preempt + replay instead of refusing
    kernel_backend: str = "ref"     # "ref" plain torch | "cuda" kernels
    replicas: tuple = ()            # per-replica ReplicaSpec overrides for a
                                    # data-parallel serve fleet; () with
                                    # partition.data=N -> N homogeneous
                                    # replicas at the cluster-level sizing

    def __post_init__(self):
        object.__setattr__(self, "replicas", tuple(self.replicas))

    @property
    def max_len(self) -> int:
        return self.prompt_len + self.gen


@dataclass(frozen=True)
class Plan:
    arch: Optional[ArchConfig] = None
    shape: Optional[ShapeConfig] = None
    cluster: ClusterSpec = field(default_factory=ClusterSpec)
    partition: PartitionSpec = field(default_factory=PartitionSpec)
    sync: SyncPolicy = field(default_factory=WSP)
    run: RunSpec = field(default_factory=RunSpec)
    serve: Optional[ServeSpec] = None
    faults: Optional[FaultPlan] = None
    fault_policy: FaultPolicy = field(default_factory=FaultPolicy)

    def __post_init__(self):
        self.validate()

    # ---- resolved views -------------------------------------------------
    @property
    def stages(self) -> int:
        return self.partition.stages or (self.arch.stages if self.arch else 1)

    @property
    def tp(self) -> int:
        return self.partition.tp or (self.arch.tp if self.arch else 1)

    @property
    def num_microbatches(self) -> int:
        return self.partition.num_microbatches or \
            (self.arch.num_microbatches if self.arch else 1)

    @property
    def vocab(self) -> int:
        return self.run.vocab or (self.arch.vocab_size if self.arch else 256)

    @property
    def devices_needed(self) -> int:
        return self.partition.devices or \
            (self.partition.data * self.stages * self.tp)

    # ---- validation -----------------------------------------------------
    def validate(self) -> None:
        if not isinstance(self.sync, SyncPolicy):
            raise TypeError(f"sync must be a SyncPolicy, got {self.sync!r}")
        self.sync.validate()
        cl, run, p = self.cluster, self.run, self.partition
        if run.backend not in ("threads", "spmd"):
            raise ValueError(f"unknown backend {run.backend!r}; expected "
                             f"'threads' or 'spmd'")
        if cl.num_vw < 1:
            raise ValueError(f"num_vw must be >= 1, got {cl.num_vw}")
        if cl.speeds is not None and len(cl.speeds) != cl.num_vw:
            raise ValueError(f"speeds has {len(cl.speeds)} entries for "
                             f"{cl.num_vw} virtual workers")
        if cl.straggle_fns is not None and \
                len(cl.straggle_fns) != cl.num_vw:
            raise ValueError(f"straggle_fns has {len(cl.straggle_fns)} "
                             f"entries for {cl.num_vw} virtual workers")
        if cl.time_scale < 0:
            raise ValueError(f"time_scale must be >= 0, got {cl.time_scale}")
        bad = [i for i, _ in cl.fail_at if not 0 <= i < cl.num_vw]
        if bad:
            raise ValueError(f"fail_at names worker indices {bad} outside "
                             f"the fleet (num_vw={cl.num_vw}); that failure "
                             f"would silently never be injected")
        if isinstance(cl.topology, str):
            make_topology(cl.topology, cl.num_vw)   # parse errors surface now
        if run.max_waves < 0 or run.batch < 1 or run.seq < 1:
            raise ValueError(f"bad run spec: max_waves={run.max_waves} "
                             f"batch={run.batch} seq={run.seq}")
        if run.codec is not None and run.compression_ratio is not None:
            raise ValueError("codec and compression_ratio are two spellings "
                             "of the same knob; set at most one")
        make_codec(run.codec)                       # parse errors surface now
        if run.compression_ratio is not None and \
                not 0.0 < run.compression_ratio <= 1.0:
            raise ValueError(f"compression_ratio must be in (0, 1], got "
                             f"{run.compression_ratio}")
        if run.ckpt_every < 0:
            raise ValueError(f"ckpt_every must be >= 0, got {run.ckpt_every}")
        if run.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or "
                             f"'bfloat16', got {run.compute_dtype!r}")
        for name in ("stages", "tp", "data", "num_microbatches", "devices"):
            if getattr(p, name) < 0:
                raise ValueError(f"partition.{name} must be >= 0")
        if run.backend == "threads" and \
                (p.stages or p.tp or (p.data != 1 and self.serve is None)):
            raise ValueError(
                "PartitionSpec.stages/tp/data factor the spmd mesh; the "
                "threads backend runs each VW's wave step whole (only "
                "partition.num_microbatches applies; on a serve Plan "
                "partition.data counts Router replicas) — unset them or "
                "use backend='spmd'")
        if run.backend == "spmd":
            self._validate_spmd()
        self._validate_faults()
        if self.serve is not None:
            self._validate_serve()
            return
        # the wave packs the per-VW batch into Nm pipeline minibatches
        if self.arch is not None or p.num_microbatches:
            nm = self.num_microbatches
            if nm >= 1 and run.batch % nm:
                raise ValueError(
                    f"per-VW batch {run.batch} is not divisible by "
                    f"num_microbatches {nm} (the wave packs the batch into "
                    f"Nm pipeline minibatches)")
        if isinstance(self.sync, BSP):
            # reject knobs the BSP loop would otherwise silently drop
            if run.codec is not None or run.compression_ratio is not None:
                raise ValueError(
                    "gradient codecs ride the parameter-server push path; "
                    "the BSP loop all-reduces raw deltas — drop "
                    "codec/compression_ratio or use a WSP policy")
            if cl.straggle_fns is not None or cl.fail_at:
                raise ValueError(
                    "straggle_fns/fail_at simulate per-worker behavior in "
                    "the threaded PS runtime; the BSP loop models "
                    "heterogeneity through cluster.speeds only")

    def _validate_spmd(self) -> None:
        """The spmd backend's mesh and the knobs it would silently drop (the
        JAX package's checks and messages)."""
        cl, run, p = self.cluster, self.run, self.partition
        if self.arch is None:
            raise ValueError("the spmd backend builds the pipelined wave "
                             "step from the architecture; Plan.arch is "
                             "required")
        model = self.stages * self.tp
        if self.devices_needed % model:
            raise ValueError(
                f"stages*tp = {self.stages}*{self.tp} = {model} does not "
                f"divide the device count {self.devices_needed}")
        if p.data * model != self.devices_needed:
            raise ValueError(
                f"mesh data*stages*tp = {p.data}*{self.stages}*{self.tp} "
                f"= {p.data * model} != devices {self.devices_needed}")
        if isinstance(self.sync, WSP):
            if self.sync.D != 0:
                raise ValueError(
                    "the spmd backend reduces every wave collectively "
                    "(D = 0); true-async D > 0 needs backend='threads'")
            if self.sync.async_push:
                raise ValueError("async_push is a threads-backend knob; "
                                 "spmd overlap is run.overlap (the skewed "
                                 "pipeline schedule)")
        elif not isinstance(self.sync, BSP):
            raise ValueError(f"spmd backend supports WSP(D=0) or BSP, got "
                             f"{self.sync.describe()}")
        if self.shape is not None:
            if self.shape.kind != "train":
                raise ValueError(f"Engine.fit trains; shape kind "
                                 f"{self.shape.kind!r} is a serving shape")
            if self.shape.seq_len != run.seq or \
                    self.shape.global_batch != p.data * run.batch:
                raise ValueError(
                    f"shape ({self.shape.global_batch}x"
                    f"{self.shape.seq_len}) disagrees with run.batch*data x "
                    f"run.seq ({p.data * run.batch}x{run.seq}); the loader "
                    f"and the wave step must see the same shapes")
        if run.codec is not None or run.compression_ratio is not None \
                or cl.topology is not None:
            raise ValueError(
                "codec/compression_ratio/topology model the host-level PS "
                "path; the spmd backend reduces in-graph — unset them or "
                "use backend='threads'")
        if cl.num_vw != 1 or cl.speeds is not None \
                or cl.straggle_fns is not None or cl.fail_at:
            raise ValueError(
                "the spmd backend's DP width is partition.data and the mesh "
                "is homogeneous; ClusterSpec heterogeneity knobs (num_vw/"
                "speeds/straggle_fns/fail_at) only drive the threaded fleet "
                "— unset them or use backend='threads'")

    def _validate_faults(self) -> None:
        """Fault scenarios are validated against the Plan they ride: event
        indices must land inside the fleet/run/batch, train events need a
        train Plan (and vice versa), and the threaded PS runtime is the
        only backend with fault seams."""
        if not isinstance(self.fault_policy, FaultPolicy):
            raise TypeError(f"fault_policy must be a FaultPolicy, got "
                            f"{self.fault_policy!r}")
        if self.faults is None:
            return
        if not isinstance(self.faults, FaultPlan):
            raise TypeError(f"faults must be a FaultPlan, got "
                            f"{self.faults!r}")
        cl, run, pol = self.cluster, self.run, self.fault_policy
        if self.serve is not None:
            bad = self.faults.of_type(*TRAIN_EVENTS)
            if bad:
                raise ValueError(
                    f"this Plan serves; training fault events "
                    f"{sorted({type(e).__name__ for e in bad})} would "
                    f"silently never fire — use SlotFault (or drop faults)")
            for ev in self.faults.of_type(SlotFault):
                if ev.slot >= self.serve.max_batch:
                    raise ValueError(
                        f"SlotFault names slot {ev.slot} outside the decode "
                        f"batch (max_batch={self.serve.max_batch})")
            replicas = max(1, self.partition.data)
            for ev in self.faults.of_type(ReplicaDown):
                if replicas == 1:
                    raise ValueError(
                        "ReplicaDown kills one replica of a data-parallel "
                        "serve fleet; this Plan has a single replica "
                        "(partition.data=1) — the Router would have no "
                        "survivor to re-dispatch onto")
                if ev.replica >= replicas:
                    raise ValueError(
                        f"ReplicaDown names replica {ev.replica} outside "
                        f"the fleet (partition.data={replicas}); that fault "
                        f"would silently never be injected")
            return
        bad = self.faults.of_type(*SERVE_EVENTS)
        if bad:
            raise ValueError(
                f"{type(bad[0]).__name__} is a serving fault; this Plan "
                f"trains — use the training events (LinkFault/WorkerCrash/"
                f"WorkerSlowdown/PSStall) or set Plan.serve")
        if run.backend != "threads" or isinstance(self.sync, BSP):
            raise ValueError(
                "fault injection seams live in the threaded parameter-"
                "server runtime (transport, PS, worker fleet); the "
                f"{'spmd' if run.backend != 'threads' else 'BSP'} backend "
                f"has none of them — drop Plan.faults or use "
                f"backend='threads' with a WSP policy")
        for ev in self.faults.of_type(WorkerCrash, WorkerSlowdown):
            if ev.vw >= cl.num_vw:
                raise ValueError(
                    f"{type(ev).__name__} names worker {ev.vw} outside the "
                    f"fleet (num_vw={cl.num_vw}); that fault would silently "
                    f"never be injected")
            if ev.wave >= run.max_waves:
                raise ValueError(
                    f"{type(ev).__name__}(vw={ev.vw}) anchors at wave "
                    f"{ev.wave} but the run stops after "
                    f"{run.max_waves} waves")
        crashes = self.faults.of_type(WorkerCrash)
        if crashes and cl.num_vw > 1 and pol.evict_lag <= 0:
            raise ValueError(
                "a WorkerCrash dies without deregistering: survivors stall "
                "at the staleness gate until the crashed worker is evicted. "
                "Set FaultPolicy.evict_lag (<= D) so the supervisor detects "
                "and evicts it, or drop the crash event")
        if crashes and pol.evict_lag > 0 and isinstance(self.sync, WSP) \
                and pol.evict_lag > max(1, self.sync.D):
            raise ValueError(
                f"FaultPolicy.evict_lag={pol.evict_lag} exceeds the "
                f"staleness bound D={self.sync.D}: survivors deadlock at "
                f"the gate before the lag detector can fire — set "
                f"evict_lag <= max(1, D)")

    def _validate_serve(self) -> None:
        """Serve-mode Plans: reject knobs the serve path would silently
        drop."""
        sv, run, cl = self.serve, self.run, self.cluster
        if not isinstance(sv, ServeSpec):
            raise TypeError(f"serve must be a ServeSpec, got {sv!r}")
        if self.arch is None:
            raise ValueError("serving builds the model from the "
                             "architecture; Plan.arch is required when "
                             "Plan.serve is set")
        if sv.prompt_len < 1 or sv.gen < 1 or sv.max_batch < 1:
            raise ValueError(f"bad serve spec: prompt_len={sv.prompt_len} "
                             f"gen={sv.gen} max_batch={sv.max_batch} "
                             f"(all must be >= 1)")
        if sv.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{sv.temperature}")
        if sv.cache_dtype not in ("", "f8"):
            raise ValueError(f"unknown serve cache_dtype "
                             f"{sv.cache_dtype!r}; expected '' (compute "
                             f"dtype) or 'f8'")
        if sv.kernel_backend not in BACKENDS:
            raise ValueError(f"unknown serve kernel_backend "
                             f"{sv.kernel_backend!r}: expected one of "
                             f"{BACKENDS}")
        if sv.page_size < 0 or sv.max_pages < 0:
            raise ValueError(f"page_size={sv.page_size} and "
                             f"max_pages={sv.max_pages} must be >= 0 "
                             f"(0 defers to the contiguous worst case)")
        from repro_torch.serve.cache import make_layout
        make_layout(sv.max_batch, sv.max_len, page_size=sv.page_size,
                    max_pages=sv.max_pages)     # geometry errors surface now
        if sv.evict and not sv.share_prefix:
            raise ValueError(
                "evict=True without share_prefix=True is a silent no-op: "
                "only the prefix index retains pages past their last "
                "mapping — enable share_prefix or drop evict")
        if self.shape is not None:
            raise ValueError("serve shapes are frozen in Plan.serve; drop "
                             "Plan.shape")
        if not isinstance(self.sync, WSP) or self.sync.D != 0 \
                or self.sync.async_push:
            raise ValueError(
                f"serving runs no gradient synchronization; Plan.sync must "
                f"be the default WSP(D=0) on a serve Plan, got "
                f"{self.sync.describe()}")
        if run.ckpt_dir or run.ckpt_every or run.resume:
            raise ValueError("ckpt_dir/ckpt_every/resume drive the training "
                             "loop; a serve Plan has no optimizer state")
        if run.codec is not None or run.compression_ratio is not None:
            raise ValueError("gradient codecs ride the training push path; "
                             "use serve.cache_dtype='f8' to shrink the cache")
        if cl.num_vw != 1 or cl.speeds is not None \
                or cl.straggle_fns is not None or cl.fail_at:
            raise ValueError(
                "ClusterSpec heterogeneity knobs (num_vw/speeds/"
                "straggle_fns/fail_at) drive the threaded training fleet; "
                "the serve path batches requests on replicas sized by "
                "partition.data + ServeSpec.replicas, and cluster.topology "
                "alone prices the Router's dispatch — unset the rest")
        p = self.partition
        if run.backend == "spmd":
            if p.data != 1 or sv.replicas:
                raise ValueError(
                    "spmd serve batches live whole on the model (stage x "
                    "tp) mesh; data-parallel serve replicas are threads-"
                    "backend only for now — set partition.data=1 (and drop "
                    "ServeSpec.replicas) or use backend='threads'")
            return          # cluster.topology: refused by _validate_spmd
        if p.data < 1:
            raise ValueError(
                f"partition.data counts the Router's serve replicas and "
                f"must be >= 1, got {p.data}")
        if isinstance(cl.topology, str):
            make_topology(cl.topology, p.data)      # parse errors now
        if sv.replicas:
            if len(sv.replicas) != p.data:
                raise ValueError(
                    f"ServeSpec.replicas carries {len(sv.replicas)} replica "
                    f"specs for partition.data={p.data} replicas; give one "
                    f"spec per replica (or none for a homogeneous fleet)")
            for i, r in enumerate(sv.replicas):
                if not isinstance(r, ReplicaSpec):
                    raise TypeError(f"ServeSpec.replicas[{i}] must be a "
                                    f"ReplicaSpec, got {r!r}")
                mb = r.max_batch or sv.max_batch
                mp = r.max_pages or sv.max_pages
                if not 1 <= mb <= sv.max_batch:
                    raise ValueError(
                        f"replica {i}: max_batch={mb} outside [1, "
                        f"ServeSpec.max_batch={sv.max_batch}] — the "
                        f"cluster-level spec is the per-replica ceiling "
                        f"(whimpy replicas shrink it, never exceed it)")
                if mp and sv.max_pages and mp > sv.max_pages:
                    raise ValueError(
                        f"replica {i}: max_pages={mp} exceeds the cluster-"
                        f"level ceiling ServeSpec.max_pages={sv.max_pages}")
                # a replica pool that cannot hold one worst-case request
                # could never admit anything — surface it here, not mid-run
                make_layout(mb, sv.max_len, page_size=sv.page_size,
                            max_pages=mp)

    # ---- ergonomics -----------------------------------------------------
    def replace(self, **kw) -> "Plan":
        """dataclasses.replace with one level of nesting via double
        underscores: plan.replace(serve__kernel_backend="cuda")."""
        nested: dict[str, dict] = {}
        top: dict[str, Any] = {}
        for k, v in kw.items():
            if "__" in k:
                head, rest = k.split("__", 1)
                nested.setdefault(head, {})[rest] = v
            else:
                top[k] = v
        for head, sub in nested.items():
            cur = top.get(head, getattr(self, head))
            top[head] = dataclasses.replace(cur, **sub)
        return dataclasses.replace(self, **top)

    def describe(self) -> str:
        arch = self.arch.name if self.arch else "<injected wave step>"
        if self.serve is not None:
            sv = self.serve
            reps = (f"replicas={self.partition.data}, "
                    if self.partition.data > 1 else "")
            return (f"Plan({arch}, serve, backend={self.run.backend}, "
                    f"{reps}batch={sv.max_batch}, prompt={sv.prompt_len}, "
                    f"gen={sv.gen}, kernels={sv.kernel_backend}, "
                    f"{'greedy' if sv.temperature == 0 else 'sampled'})")
        topo = self.cluster.topology
        topo = topo if isinstance(topo, (str, type(None))) else "custom"
        return (f"Plan({arch}, backend={self.run.backend}, "
                f"vw={self.cluster.num_vw}, topology={topo}, "
                f"{self.sync.describe()}, waves={self.run.max_waves})")
