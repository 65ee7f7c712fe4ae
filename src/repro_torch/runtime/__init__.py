"""Host-side serving runtime: the slot-based request scheduler behind the
continuous-batching engine (``scheduler.py``), the seeded SEU injector
(``faults.py``) and recovery (``recovery.py``: retries, stragglers,
heartbeats)."""

from repro_torch.runtime.recovery import HealthMonitor, StragglerDetector, retry_step
from repro_torch.runtime.scheduler import Request, SchedulerStats, SlotScheduler

__all__ = [
    "HealthMonitor",
    "Request",
    "SchedulerStats",
    "SlotScheduler",
    "StragglerDetector",
    "retry_step",
]
