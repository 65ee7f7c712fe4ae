"""Host-side serving runtime: the slot-based request scheduler behind the
continuous-batching engine (``scheduler.py``), the seeded SEU injector
(``faults.py``), recovery (``recovery.py``: retries, stragglers,
heartbeats) and the SLA autopilot controller (``autopilot.py``)."""

from repro_torch.runtime.autopilot import (
    Autopilot,
    AutopilotDecision,
    AutopilotPolicy,
    OverloadError,
)
from repro_torch.runtime.recovery import (
    ElasticMesh,
    HealthMonitor,
    StragglerDetector,
    retry_step,
)
from repro_torch.runtime.scheduler import Request, SchedulerStats, SlotScheduler

__all__ = [
    "Autopilot",
    "AutopilotDecision",
    "AutopilotPolicy",
    "ElasticMesh",
    "HealthMonitor",
    "OverloadError",
    "Request",
    "SchedulerStats",
    "SlotScheduler",
    "StragglerDetector",
    "retry_step",
]
