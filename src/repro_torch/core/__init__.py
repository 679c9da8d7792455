"""repro_torch.core — the paper's contribution (Relic fine-grained tasking)
at three scales: host threads (relic), the device's transfer and compute
lanes (lanes + kernels), and rings across devices (collective_matmul,
pipeline) on torch.distributed."""

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
from repro_torch.core.lanes import two_lane_ring, two_lane_ring_db
from repro_torch.core.pipeline import pipeline_apply, split_stages
from repro_torch.core import collective_matmul

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
    "two_lane_ring",
    "two_lane_ring_db",
    "pipeline_apply",
    "split_stages",
    "collective_matmul",
]
