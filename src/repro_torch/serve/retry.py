"""Retry policy for the serving layer: bounded, backed-off, deterministic.

Serving on a fallible substrate needs a re-admission story: a request can
fail because *it* is buggy (retrying is wasted work) or because the lane
under it died (retrying is exactly right). The policy here is the standard
production shape — bounded attempts, exponential backoff, jitter — with two
repo-specific disciplines:

* **Opt-in by idempotency.** Only requests submitted with
  ``idempotent=True`` are ever retried: the server cannot know whether
  re-running a side-effecting thunk is safe, so the client declares it.
  Everything else fails fast on the first error (the PR 7 behaviour,
  unchanged).
* **Deterministic jitter.** The jitter term is seeded from
  ``(policy.seed, rid, attempt)``, not wall-clock entropy — two runs of
  the same workload back off identically, so fault-injection tests and the
  ``faults`` benchmark section are reproducible (the same discipline as
  ``repro_torch.runtime.chaos``).

``max_attempts`` counts *total* executions (first try included), so the
``RELIC_SERVE_RETRIES`` knob — "how many extra attempts" — maps to
``max_attempts = retries + 1`` via :meth:`RetryPolicy.from_config`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.runtime.config import ServeConfig

__all__ = ["RetryPolicy"]


@dataclass(frozen=True)
class RetryPolicy:
    """Frozen retry parameters for one server instance.

    ``delay(rid, attempt)`` gives the backoff before re-admission
    ``attempt + 1`` of request ``rid`` (``attempt`` is the number of
    executions already spent, so the first retry passes ``attempt=1``):
    ``base_backoff_s * multiplier**(attempt-1)`` capped at
    ``max_backoff_s``, then scaled by a deterministic jitter factor in
    ``[1 - jitter, 1 + jitter]``.
    """

    max_attempts: int = 3
    base_backoff_s: float = 0.001
    multiplier: float = 2.0
    max_backoff_s: float = 0.050
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_backoff_s < 0:
            raise ValueError(
                f"base_backoff_s must be >= 0, got {self.base_backoff_s}")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1, got {self.multiplier}")
        if self.max_backoff_s < self.base_backoff_s:
            raise ValueError(
                "max_backoff_s must be >= base_backoff_s "
                f"(got {self.max_backoff_s} < {self.base_backoff_s})")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(
                f"jitter must be in [0, 1), got {self.jitter}")

    @classmethod
    def from_config(cls, config: ServeConfig, seed: int = 0) -> "RetryPolicy":
        """Map the resolved ``RELIC_SERVE_RETRIES`` knob (extra attempts)
        onto a policy (total attempts)."""
        return cls(max_attempts=config.retries + 1, seed=seed)

    @property
    def retries(self) -> int:
        """Extra attempts beyond the first (the knob's unit)."""
        return self.max_attempts - 1

    def allows(self, attempts_spent: int) -> bool:
        """May a request that has already executed ``attempts_spent``
        times be re-admitted?"""
        return attempts_spent < self.max_attempts

    def delay(self, rid: int, attempt: int) -> float:
        """Seconds to wait before re-admission; deterministic per
        ``(seed, rid, attempt)``."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        back = self.base_backoff_s * self.multiplier ** (attempt - 1)
        if back > self.max_backoff_s:
            back = self.max_backoff_s
        if self.jitter:
            # Mix the identifiers into one int seed (tuple hashes vary
            # less portably than plain arithmetic).
            mixed = (self.seed * 1_000_003 + rid) * 1_000_003 + attempt
            rng = random.Random(mixed)
            back *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return back
