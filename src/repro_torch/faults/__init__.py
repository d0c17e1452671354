"""repro_torch.faults — the typed errors of the training runtime (the port
of repro.faults.errors). Fault scenarios, their injector and the fleet
supervisor are ROADMAP Queue 1 item 7."""
from repro_torch.faults.errors import (  # noqa: F401
    DegradedRunError, FaultError, GateTimeout,
)
