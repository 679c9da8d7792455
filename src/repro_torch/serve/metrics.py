"""Streaming latency/throughput accounting for the serving subsystem.

The generic primitives — ``nearest_rank``/``percentiles``, ``LatencySeries``
and ``Gauge`` — live in :mod:`repro_torch.runtime.metrics` (moved there in PR 9 so
the streaming executor's stage-latency/occupancy rows share them); this
module re-exports them unchanged, identity-pinned by
``tests/test_runtime_metrics.py`` — the same compatibility pattern as
``resolve_spin_pause_every`` re-exported from ``repro_torch.core.relic`` after its
move into ``repro_torch.runtime.config`` (PR 7). Existing
``from repro_torch.serve.metrics import ...`` call sites keep working.

What stays here is the serving-specific aggregate: ``ServeMetrics``.
Single-writer discipline mirrors ``RelicStats``/``RelicPoolStats``: every
mutator is called from exactly one thread (the scheduler loop), readers take
racy-but-monotonic snapshots from any thread.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.runtime.metrics import (  # noqa: F401  (re-exports, identity-pinned)
    Gauge,
    LatencySeries,
    nearest_rank,
    percentiles,
)


@dataclass
class ServeMetrics:
    """Live counters + series for one ``ServeScheduler`` instance.

    All mutators run on the scheduler loop thread except ``note_rejected``
    (incremented per *client* on the client's own thread inside
    ``ClientHandle``, summed here at snapshot time — no shared counter on
    the submit hot path).
    """

    completed: int = 0          # responses finished, any status
    ok: int = 0
    errors: int = 0
    deadline_exceeded: int = 0  # ran (or was shed) past its deadline
    cancelled: int = 0          # still queued/in-flight at stop()
    admitted: int = 0

    queue_depth: Gauge = field(default_factory=Gauge)
    batch_occupancy: Gauge = field(default_factory=Gauge)

    latency: LatencySeries = field(default_factory=LatencySeries)
    queue_delay: LatencySeries = field(default_factory=LatencySeries)
    ttfr: LatencySeries = field(default_factory=LatencySeries)  # first result

    first_arrival_t: Optional[float] = None
    last_complete_t: Optional[float] = None

    def note_arrival(self, t: float) -> None:
        if self.first_arrival_t is None or t < self.first_arrival_t:
            self.first_arrival_t = t

    def note_complete(self, resp) -> None:
        """Fold a finished Response into the counters (loop thread only)."""
        self.completed += 1
        status = resp.status
        if status == "ok":
            self.ok += 1
        elif status == "error":
            self.errors += 1
        elif status == "deadline_exceeded":
            self.deadline_exceeded += 1
        else:
            self.cancelled += 1
        req = resp.request
        self.note_arrival(req.arrival_t)
        t = resp.complete_t
        if t is not None:
            if self.last_complete_t is None or t > self.last_complete_t:
                self.last_complete_t = t
            self.latency.add(t - req.arrival_t)
        if req.admit_t is not None:
            self.queue_delay.add(req.admit_t - req.arrival_t)
        if resp.first_result_t is not None:
            self.ttfr.add(resp.first_result_t - req.arrival_t)

    @property
    def throughput(self) -> float:
        """Completed requests per second over the observed span."""
        if (
            self.first_arrival_t is None
            or self.last_complete_t is None
            or self.last_complete_t <= self.first_arrival_t
        ):
            return 0.0
        return self.completed / (self.last_complete_t - self.first_arrival_t)

    def snapshot(self, rejected: int = 0) -> dict:
        """RelicPoolStats-style live snapshot (racy reads are fine — every
        field is a single reference/int assignment)."""
        lat = self.latency.snapshot()
        out = {
            "completed": self.completed,
            "ok": self.ok,
            "errors": self.errors,
            "deadline_exceeded": self.deadline_exceeded,
            "cancelled": self.cancelled,
            "admitted": self.admitted,
            "rejected": rejected,
            "throughput_rps": self.throughput,
            "queue_depth": self.queue_depth.asdict(),
            "batch_occupancy": self.batch_occupancy.asdict(),
        }
        if lat:
            ordered = sorted(lat)
            out["latency_s"] = {
                "p50": nearest_rank(ordered, 50),
                "p95": nearest_rank(ordered, 95),
                "p99": nearest_rank(ordered, 99),
                "mean": sum(ordered) / len(ordered),
                "n": len(ordered),
            }
        return out


def now() -> float:
    """The one clock the serving subsystem stamps with (monotonic)."""
    return time.perf_counter()
