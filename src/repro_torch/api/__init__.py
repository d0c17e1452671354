"""repro_torch.api — the declarative experiment surface of the port.

    from repro_torch.api import Engine, get_preset
    report = Engine(get_preset("single_node")).fit()          # WSP training
    from repro_torch.api.serving import Request, Scheduler
    report = Scheduler(Engine(get_preset("serve_kernels"))).run(requests)

Plans are frozen and validated at construction (repro_torch.api.plan); the
Engine runs them on the CUDA card (or device="cpu"): fit()/step() train
under WSP, ASP or BSP, and repro_torch.api.serving adds the
continuous-batching Scheduler. A serve Plan with partition.data > 1 and
`ServeSpec.replicas` (ReplicaSpec each) is a replica fleet for
repro_torch.serve.router's Router. `Plan(faults=FaultPlan(...),
fault_policy=FaultPolicy(...))` injects seeded failures into the threaded
runtime and the Scheduler, with retry/backoff, heartbeat eviction, elastic
rejoin and serve-side recovery (see repro_torch.faults).
"""
from repro_torch.api.engine import Engine
from repro_torch.api.plan import (ClusterSpec, PartitionSpec, Plan,
                                  ReplicaSpec, RunSpec, ServeSpec)
from repro_torch.api.presets import PRESETS, get_preset, list_presets
from repro_torch.api.report import (RequestStats, ServeReport, Telemetry,
                                    TrainReport)
from repro_torch.api.sync import ASP, BSP, SyncPolicy, UNBOUNDED_D, WSP
from repro_torch.faults import (DegradedRunError, FaultPlan, FaultPolicy,
                                GateTimeout, LinkFault, PSStall, PushTimeout,
                                ReplicaDown, SlotFault, TransportError,
                                WorkerCrash, WorkerSlowdown)

__all__ = [
    "ASP", "BSP", "ClusterSpec", "DegradedRunError", "Engine", "FaultPlan",
    "FaultPolicy", "GateTimeout", "LinkFault", "PSStall", "PartitionSpec",
    "Plan", "PRESETS", "PushTimeout", "ReplicaDown", "ReplicaSpec",
    "RequestStats", "RunSpec", "ServeReport", "ServeSpec", "SlotFault",
    "SyncPolicy", "Telemetry", "TrainReport", "TransportError",
    "UNBOUNDED_D", "WSP", "WorkerCrash", "WorkerSlowdown", "get_preset",
    "list_presets",
]
