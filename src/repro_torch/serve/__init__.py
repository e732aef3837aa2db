"""Serving layer: the sync size-or-deadline batcher (batcher.py), the
shard-aware async service on shard lanes (service.py, DESIGN.md §10)
with its deadline scheduler (scheduler.py), cross-query representation
cache (repcache.py), wall-clock event host (host.py), overload/fault
hardening (faults.py — typed Shed/TimedOut results, fault plans;
DESIGN.md §12), plus the LM decode cache (kvcache.py)."""
from repro_torch.serve.batcher import (Batcher, BatcherStats, CascadeService,
                                       Request)
from repro_torch.serve.faults import (DeviceError, FaultInjector, FaultPlan,
                                      NeverReadyLabels, Shed, TimedOut,
                                      TransientComputeError, is_label)
from repro_torch.serve.host import EventHost, FakeTimer, WallTimer
from repro_torch.serve.repcache import RepresentationCache
from repro_torch.serve.scheduler import DeadlineWheel, ManualClock
from repro_torch.serve.service import (AsyncCascadeService, DegradeConfig,
                                       ServiceStats)

__all__ = [
    "AsyncCascadeService", "Batcher", "BatcherStats", "CascadeService",
    "DeadlineWheel", "DegradeConfig", "DeviceError", "EventHost",
    "FakeTimer", "FaultInjector", "FaultPlan", "ManualClock",
    "NeverReadyLabels", "RepresentationCache", "Request", "ServiceStats",
    "Shed", "TimedOut", "TransientComputeError", "WallTimer", "is_label",
]
