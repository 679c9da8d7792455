"""Central resolver for env-var runtime knobs (alpa ``global_env.py`` shape).

Every tunable that the runtime reads from the environment lives here, in one
place, with one discipline: knobs are **re-read per instance** (a new
``Relic``/``RelicPool``/``ServeScheduler`` picks up the current environment),
never frozen at import time, so a CI container and a local SMT host can run
the same code path by exporting a variable instead of editing a module.

Two families:

``RELIC_SPIN_PAUSE_EVERY``
    The spin/yield cadence for the busy-wait loops (paper §VI-B). Moved here
    from ``repro_torch.core.relic`` (which still re-exports it for back-compat).

``RELIC_SERVE_*``
    Knobs for the ``repro_torch.serve`` request-serving subsystem:

    - ``RELIC_SERVE_ADMISSION``: ``block`` (default) or ``reject`` — what a
      client submit does when its SPSC request ring is full.
    - ``RELIC_SERVE_QUEUE_DEPTH``: per-client request-ring capacity
      (default 64).
    - ``RELIC_SERVE_BATCH_MAX``: max in-flight requests the continuous
      batcher keeps admitted at once (default 8).
    - ``RELIC_SERVE_DEADLINE_MS``: default per-request deadline in
      milliseconds; unset/empty means no deadline.
    - ``RELIC_SERVE_RETRIES``: max *extra* attempts the server grants an
      idempotent-marked request whose task erred or whose lane died
      (default 2; ``0`` disables retry).

``RELIC_SUPERVISE`` / ``RELIC_HEARTBEAT_MS``
    The liveness/supervision knobs (docs/robustness.md):

    - ``RELIC_SUPERVISE``: ``1`` (default) arms the bounded-wait liveness
      probes (every producer spin loop periodically checks
      ``assistant.is_alive()`` and raises ``RelicDeadError`` instead of
      hanging) and the pool's ``LaneSupervisor``; ``0`` restores the
      pre-supervision behaviour exactly (unbounded spins).
    - ``RELIC_HEARTBEAT_MS``: cadence (milliseconds, default 100) at which
      the ``LaneSupervisor`` samples per-lane progress heartbeats into
      ``HeartbeatTracker``/``StragglerMonitor``; a lane with outstanding
      work and no progress for one full period is flagged as stalled.

``RELIC_CKPT_CHECKSUM``
    Crash-consistency knob for ``repro_torch.checkpoint``: ``1`` (default) makes
    ``CheckpointManager`` record a CRC32 per entry in the manifest and
    verify it on restore (falling back to the next-latest valid step on a
    mismatch); ``0`` skips both (the pre-PR-10 format, still restorable —
    entries without a checksum are simply not verified).

``resolve_serve_config()`` / ``resolve_supervise_config()`` /
``resolve_checkpoint_config()`` return frozen snapshots recorded in BENCH
meta alongside the spin cadence, so a recorded run's knob state is
reproducible.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from typing import Optional


def _default_spin_yield() -> int:
    """`pause`-cadence adaptation: the paper assumes two hardware contexts
    (SMT, §VI) — producer + assistant fit exactly one SMT core. Yield hot
    (every iteration) only when the two runtime threads actually outnumber
    the host's contexts, i.e. on a 1-context host, where spin-waiting
    starves the partner thread across the GIL. With 2+ contexts — the
    paper's own target shape included — spin mostly-hot and yield rarely.
    (The old threshold ``< 2 + 1`` misclassified a 2-context host as
    oversubscribed, forcing the paper's §VI scenario onto the
    yield-every-iteration cadence: the PR 6 bugfix.)"""
    return 1 if (os.cpu_count() or 1) < 2 else 64


def _positive_int(name: str, raw: str) -> int:
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be a positive int, got {raw!r}") from None
    if value <= 0:
        raise ValueError(f"{name} must be a positive int, got {raw!r}")
    return value


def resolve_spin_pause_every() -> int:
    """The spin/yield cadence for a *new* runtime instance: the
    ``RELIC_SPIN_PAUSE_EVERY`` env var when set (a positive int), else the
    cpu-count heuristic. Re-read per ``Relic``/``RelicPool``/worker
    instance — not frozen at import — so a 2-cpu CI container and a local
    SMT host can be benchmarked against the same code path by exporting
    one variable instead of editing the module."""
    raw = os.environ.get("RELIC_SPIN_PAUSE_EVERY")
    if raw is None or raw == "":
        return _default_spin_yield()
    return _positive_int("RELIC_SPIN_PAUSE_EVERY", raw)


_ADMISSION_POLICIES = ("block", "reject")


@dataclass(frozen=True)
class ServeConfig:
    """Resolved ``RELIC_SERVE_*`` knob snapshot for one serving instance."""

    admission: str = "block"
    queue_depth: int = 64
    batch_max: int = 8
    deadline_ms: Optional[float] = None
    retries: int = 2

    def asdict(self) -> dict:
        return asdict(self)


def resolve_serve_config(
    *,
    admission: Optional[str] = None,
    queue_depth: Optional[int] = None,
    batch_max: Optional[int] = None,
    deadline_ms: Optional[float] = None,
    retries: Optional[int] = None,
) -> ServeConfig:
    """Resolve the serving knobs for a *new* ``ServeScheduler``/``Ingest``.

    Explicit keyword arguments (from code or CLI flags) win over the
    environment; the environment wins over the defaults. Like
    ``resolve_spin_pause_every`` this is re-read per instance.
    """
    if admission is None:
        raw = os.environ.get("RELIC_SERVE_ADMISSION")
        admission = raw if raw else "block"
    if admission not in _ADMISSION_POLICIES:
        raise ValueError(
            "RELIC_SERVE_ADMISSION must be one of "
            f"{_ADMISSION_POLICIES}, got {admission!r}")

    if queue_depth is None:
        raw = os.environ.get("RELIC_SERVE_QUEUE_DEPTH")
        queue_depth = _positive_int(
            "RELIC_SERVE_QUEUE_DEPTH", raw) if raw else 64

    if batch_max is None:
        raw = os.environ.get("RELIC_SERVE_BATCH_MAX")
        batch_max = _positive_int(
            "RELIC_SERVE_BATCH_MAX", raw) if raw else 8

    if deadline_ms is None:
        raw = os.environ.get("RELIC_SERVE_DEADLINE_MS")
        if raw:
            try:
                deadline_ms = float(raw)
            except ValueError:
                raise ValueError(
                    "RELIC_SERVE_DEADLINE_MS must be a positive number, "
                    f"got {raw!r}") from None
    if deadline_ms is not None and deadline_ms <= 0:
        raise ValueError(
            "RELIC_SERVE_DEADLINE_MS must be a positive number, "
            f"got {deadline_ms!r}")

    if retries is None:
        raw = os.environ.get("RELIC_SERVE_RETRIES")
        retries = _non_negative_int(
            "RELIC_SERVE_RETRIES", raw) if raw else 2
    elif not isinstance(retries, int) or retries < 0:
        raise ValueError(
            f"RELIC_SERVE_RETRIES must be a non-negative int, got {retries!r}")

    return ServeConfig(
        admission=admission,
        queue_depth=queue_depth,
        batch_max=batch_max,
        deadline_ms=deadline_ms,
        retries=retries,
    )


def _non_negative_int(name: str, raw: str) -> int:
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be a non-negative int, got {raw!r}") from None
    if value < 0:
        raise ValueError(f"{name} must be a non-negative int, got {raw!r}")
    return value


_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


@dataclass(frozen=True)
class SuperviseConfig:
    """Resolved ``RELIC_SUPERVISE``/``RELIC_HEARTBEAT_MS`` knob snapshot
    for one runtime instance (a ``Relic``, a ``RelicPool``, a
    ``ServeScheduler``)."""

    supervise: bool = True
    heartbeat_ms: float = 100.0

    def asdict(self) -> dict:
        return asdict(self)


def resolve_supervise_config(
    *,
    supervise: Optional[bool] = None,
    heartbeat_ms: Optional[float] = None,
) -> SuperviseConfig:
    """Resolve the liveness-supervision knobs for a *new* runtime instance.

    Same discipline as ``resolve_serve_config``: explicit keyword arguments
    win over the environment, the environment wins over the defaults,
    invalid values raise ``ValueError``, and the result is re-read per
    instance (never frozen at import).
    """
    if supervise is None:
        raw = os.environ.get("RELIC_SUPERVISE")
        if raw is None or raw == "":
            supervise = True
        elif raw.strip().lower() in _TRUTHY:
            supervise = True
        elif raw.strip().lower() in _FALSY:
            supervise = False
        else:
            raise ValueError(
                f"RELIC_SUPERVISE must be one of {_TRUTHY + _FALSY}, "
                f"got {raw!r}")

    if heartbeat_ms is None:
        raw = os.environ.get("RELIC_HEARTBEAT_MS")
        if raw:
            try:
                heartbeat_ms = float(raw)
            except ValueError:
                raise ValueError(
                    "RELIC_HEARTBEAT_MS must be a positive number, "
                    f"got {raw!r}") from None
        else:
            heartbeat_ms = 100.0
    if heartbeat_ms <= 0:
        raise ValueError(
            "RELIC_HEARTBEAT_MS must be a positive number, "
            f"got {heartbeat_ms!r}")

    return SuperviseConfig(supervise=bool(supervise),
                           heartbeat_ms=float(heartbeat_ms))


@dataclass(frozen=True)
class CheckpointConfig:
    """Resolved ``RELIC_CKPT_CHECKSUM`` knob snapshot for one
    ``CheckpointManager`` instance."""

    checksum: bool = True

    def asdict(self) -> dict:
        return asdict(self)


def resolve_checkpoint_config(
    *,
    checksum: Optional[bool] = None,
) -> CheckpointConfig:
    """Resolve the checkpoint crash-consistency knobs for a *new* manager.

    Same discipline as the other resolvers: explicit keyword arguments win
    over the environment, the environment wins over the defaults, invalid
    values raise ``ValueError``, re-read per instance.
    """
    if checksum is None:
        raw = os.environ.get("RELIC_CKPT_CHECKSUM")
        if raw is None or raw == "":
            checksum = True
        elif raw.strip().lower() in _TRUTHY:
            checksum = True
        elif raw.strip().lower() in _FALSY:
            checksum = False
        else:
            raise ValueError(
                f"RELIC_CKPT_CHECKSUM must be one of {_TRUTHY + _FALSY}, "
                f"got {raw!r}")
    return CheckpointConfig(checksum=bool(checksum))
