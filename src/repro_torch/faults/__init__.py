"""repro_torch.faults — deterministic fault injection and elastic recovery.

The WSP proof (paper Section 4) bounds staleness for whatever set of
virtual workers is *live*, which means the system should tolerate slow,
flapping and dead workers by design. This package makes that claim
testable:

  plan        frozen, seeded `FaultPlan` (link outages/degradation,
              message loss, worker crash/slowdown onset, PS stalls, serve
              slot faults) + the `FaultPolicy` recovery knobs
  injector    the plan compiled into O(1) runtime lookups, consulted at
              the three seams: SimulatedTransport (per-message verdicts),
              ParameterServer (push stalls), Scheduler (slot faults)
  supervisor  heartbeat-driven eviction of dead/stalled workers from the
              WSP clock + elastic rejoin from the PS's atomic state
  errors      typed failures: TransportError, PushTimeout, GateTimeout,
              DegradedRunError

Attach a scenario to a Plan with `Plan(faults=FaultPlan(...),
fault_policy=FaultPolicy(...))`; every injected fault and recovery action
lands in the repro_torch.obs trace so `repro_torch.obs.summary` can audit
that recovery respected the staleness bound D. (A copy of repro.faults: the
same seeded scenarios give the same events, verdicts and fault digests.)
"""
from repro_torch.faults.errors import (DegradedRunError, FaultError,
                                       GateTimeout, PushTimeout,
                                       TransportError)
from repro_torch.faults.injector import FaultInjector
from repro_torch.faults.plan import (FaultPlan, FaultPolicy, LinkFault,
                                     PSStall, ReplicaDown, SlotFault,
                                     WorkerCrash, WorkerSlowdown)
from repro_torch.faults.supervisor import Eviction, FleetSupervisor

__all__ = [
    "DegradedRunError", "Eviction", "FaultError", "FaultInjector",
    "FaultPlan", "FaultPolicy", "FleetSupervisor", "GateTimeout",
    "LinkFault", "PSStall", "PushTimeout", "ReplicaDown", "SlotFault",
    "TransportError", "WorkerCrash", "WorkerSlowdown",
]
