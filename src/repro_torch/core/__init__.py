"""repro_torch.core — the paper's contribution (Relic fine-grained tasking)
at host-thread scale. The JAX package's multi-device pieces (lanes,
pipeline, collective_matmul) are not ported yet; see ROADMAP.md."""

from repro_torch.core.spsc import SpscRing, DEFAULT_CAPACITY
from repro_torch.core.relic import Relic, RelicStats, RelicUsageError
from repro_torch.core.relic_pool import RelicPool, RelicPoolStats
from repro_torch.core.schedulers import (
    Scheduler,
    SchedulerStats,
    SchedulerUsageError,
    available_schedulers,
    make_scheduler,
)

__all__ = [
    "SpscRing",
    "DEFAULT_CAPACITY",
    "Relic",
    "RelicStats",
    "RelicUsageError",
    "RelicPool",
    "RelicPoolStats",
    "Scheduler",
    "SchedulerStats",
    "SchedulerUsageError",
    "available_schedulers",
    "make_scheduler",
]
