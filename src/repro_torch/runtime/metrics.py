"""Shared single-writer metrics primitives (percentiles, series, gauges).

Home of the nearest-rank percentile helpers, :class:`LatencySeries` and
:class:`Gauge`, moved here from ``repro_torch.serve.metrics`` (PR 9) so the
streaming executor's per-stage latency/occupancy rows reuse them instead of
duplicating — the same move pattern as ``resolve_spin_pause_every``
migrating into ``repro_torch.runtime.config`` (PR 7). ``repro_torch.serve.metrics``
re-exports every name, identity-pinned by ``tests/test_runtime_metrics.py``,
so existing imports keep working unchanged.

Single-writer discipline mirrors ``RelicStats``/``RelicPoolStats``: every
mutator is called from exactly one thread (a scheduler loop, a stream-stage
loop), readers take racy-but-monotonic snapshots from any thread.
Percentiles use the **nearest-rank** definition (rank ``ceil(q/100 * n)``,
1-based into the sorted sample) — the classical textbook estimator, equal
to ``numpy.percentile(..., method="inverted_cdf")``, pinned against it by
``tests/test_serve.py`` on adversarial sizes (n=1, n=2, ties, all-equal).
Nearest-rank always returns an *observed* sample, which is what an SLO
report wants: "p99 = 4.1 ms" names a request that actually took 4.1 ms,
not an interpolation between two that didn't.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

__all__ = ["nearest_rank", "percentiles", "LatencySeries", "Gauge"]


def nearest_rank(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted non-empty sample.

    ``q`` in (0, 100]. Rank is ``ceil(q/100 * n)`` (1-based); q=0 is mapped
    to rank 1 so ``nearest_rank(xs, 0) == min(xs)``.
    """
    n = len(sorted_values)
    if n == 0:
        raise ValueError("nearest_rank of an empty sample")
    if not 0 <= q <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {q!r}")
    rank = max(1, math.ceil(q / 100.0 * n))
    return sorted_values[rank - 1]


def percentiles(
    values: Sequence[float], qs: Sequence[float] = (50, 95, 99)
) -> Dict[float, float]:
    """Nearest-rank percentiles of an (unsorted) non-empty sample."""
    ordered = sorted(values)
    return {q: nearest_rank(ordered, q) for q in qs}


class LatencySeries:
    """Append-only latency sample series (seconds). Single writer; readers
    call ``snapshot()`` which copies before sorting so the writer is never
    blocked and a concurrent append can at worst be missed, not torn."""

    __slots__ = ("_values",)

    def __init__(self) -> None:
        self._values: List[float] = []

    def add(self, value: float) -> None:
        self._values.append(value)

    def __len__(self) -> int:
        return len(self._values)

    def snapshot(self) -> List[float]:
        return list(self._values)

    def percentiles(
        self, qs: Sequence[float] = (50, 95, 99)
    ) -> Dict[float, float]:
        return percentiles(self.snapshot(), qs)


@dataclass
class Gauge:
    """Last/min/max/mean of a sampled quantity (queue depth, batch
    occupancy, stage input-ring depth). Single writer; ``mean`` is
    total/samples."""

    last: float = 0.0
    min: float = math.inf
    max: float = -math.inf
    total: float = 0.0
    samples: int = 0

    def observe(self, value: float) -> None:
        self.last = value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self.total += value
        self.samples += 1

    @property
    def mean(self) -> float:
        return self.total / self.samples if self.samples else 0.0

    def asdict(self) -> dict:
        if not self.samples:
            return {"last": 0.0, "min": 0.0, "max": 0.0, "mean": 0.0}
        return {
            "last": self.last, "min": self.min,
            "max": self.max, "mean": self.mean,
        }
