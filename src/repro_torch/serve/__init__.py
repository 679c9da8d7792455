"""repro_torch.serve: continuous-batching request serving on the Relic substrate.

The production form of the paper's "latency-critical" framing: a request
server whose every queue is the same lock-free SPSC ring the Relic pair
runs on (FastFlow's composition claim), whose batcher admits mid-stream
with no barrier between batches, and whose SLO accounting (nearest-rank
p50/p95/p99, deadlines surfaced as ``deadline_exceeded``) is first-class.

See docs/serving.md for the architecture and ``benchmarks/run.py --only
serve`` for the latency-vs-offered-load measurement.
"""

from repro_torch.serve.ingest import (
    ClientHandle,
    Ingest,
    RejectedError,
    ServeUsageError,
)
from repro_torch.serve.loadgen import (
    LoadResult,
    poisson_arrivals,
    run_closed_loop,
    run_open_loop,
)
from repro_torch.serve.metrics import (
    Gauge,
    LatencySeries,
    ServeMetrics,
    nearest_rank,
    percentiles,
)
from repro_torch.serve.request import (
    Request,
    Response,
    STATUS_CANCELLED,
    STATUS_DEADLINE,
    STATUS_ERROR,
    STATUS_OK,
)
from repro_torch.serve.retry import RetryPolicy
from repro_torch.serve.scheduler import ServeScheduler

__all__ = [
    "ClientHandle",
    "Gauge",
    "Ingest",
    "LatencySeries",
    "LoadResult",
    "RejectedError",
    "Request",
    "Response",
    "RetryPolicy",
    "STATUS_CANCELLED",
    "STATUS_DEADLINE",
    "STATUS_ERROR",
    "STATUS_OK",
    "ServeMetrics",
    "ServeScheduler",
    "ServeUsageError",
    "nearest_rank",
    "percentiles",
    "poisson_arrivals",
    "run_closed_loop",
    "run_open_loop",
]
