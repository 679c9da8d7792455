"""Chaos harness: seeded, deterministic fault injection for the runtime.

Robustness claims are only as good as the faults they were tested against,
and ad-hoc "kill a thread in a test" coverage rots. This module makes fault
injection a first-class, *reproducible* input to the existing machinery:

* :class:`ChaosSpec` — one frozen, validated description of a fault mix
  (task-raise rate, task-stall rate/duration, assistant-kill point,
  admission-burst intensity), parseable from the ``RELIC_CHAOS`` env var so
  CI can re-run a whole suite under a pinned fault plan.
* :class:`FaultPlan` — the seeded per-task decision stream. Decorating a
  task draws once from a private ``random.Random(seed)``: same spec, same
  submission order ⇒ byte-identical fault placement, every run.
* :class:`ChaosScheduler` — a scheduler-SPI *wrapper* substrate registered
  as ``"chaos"``: it decorates every submitted task per the plan and
  delegates everything else to an inner substrate from the registry
  (``spec.inner``, default ``relic``). Because registration makes it a
  peer of the real substrates, the conformance suite picks it up
  automatically (tests/test_schedulers_conformance.py's registry tripwire)
  and re-runs the *entire* observable contract under injected faults — the
  default spec is therefore semantics-preserving (stall-only: stalls delay
  a task but still run it; ``raise_rate`` defaults to 0 because a raise
  replaces the task's effect and only dedicated tests opt into that).
* :class:`KillSwitch` — arms the assistant-kill hook ``Relic`` exposes for
  tests (``_chaos_kill``, a ``None``-checked callable off the hot path):
  the assistant thread exits mid-loop after a chosen number of drained
  bursts, losing the popped burst — the deterministic "lane died with
  in-flight work" scenario the supervision layer must account for exactly.
* :class:`StageKillSwitch` — the same idea one stratum up, for *stream
  loop tasks*: a ``repro_torch.stream.Stage`` consults its own ``_chaos_kill``
  hook once per popped item, and a fired switch kills the stage loop with
  that item popped but unprocessed — the deterministic "dead farm worker
  with in-flight tags" scenario the stream recovery layer (quarantine +
  re-emit, ``stream/farm.py``) must account for exactly.
* :class:`FsFaultInjector` — deterministic filesystem faults for the
  persistence layer: crash a ``CheckpointManager`` save at a *named*
  point (before serialization, between entry files, mid-``manifest.json``
  write — leaving a torn manifest — or between serialize and publish) by
  raising :class:`FsCrash`, a ``BaseException`` so it models a process
  death, not a handleable task error. Every crash-consistency path in
  ``checkpoint/manager.py`` is testable without timing games.

No module-level import of ``repro_torch.core.schedulers`` (it imports the relic
family, which must stay importable without this module): the registry is
resolved lazily inside ``ChaosScheduler.__init__``, and registration of
the ``"chaos"`` name happens at the bottom of ``schedulers.py`` so the
registry is complete the moment it is importable.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Iterable, List, Optional, Tuple

__all__ = [
    "ChaosInjectedError",
    "ChaosSpec",
    "FaultPlan",
    "KillSwitch",
    "StageKillSwitch",
    "FsCrash",
    "FsFaultInjector",
    "ChaosScheduler",
    "plan_bursts",
]


class ChaosInjectedError(RuntimeError):
    """The error an injected task-raise fault throws. Its own type so
    assertions can distinguish injected faults from real bugs."""


@dataclass(frozen=True)
class ChaosSpec:
    """One validated, frozen fault mix.

    ``raise_rate`` / ``stall_rate`` are per-task probabilities (drawn from
    one seeded stream — see :class:`FaultPlan`); ``stall_s`` is the
    straggler stall duration; ``kill_after`` arms a :class:`KillSwitch`
    (``None`` = never kill); ``burst`` is the admission-burst intensity
    (max requests per burst for ``plan_bursts``); ``inner`` names the
    wrapped substrate for :class:`ChaosScheduler`.

    The defaults are deliberately *semantics-preserving* (mild stall-only)
    so the full conformance suite passes under them: a stalled task still
    runs, in order, with its real result and its real exception.
    """

    seed: int = 0
    raise_rate: float = 0.0
    stall_rate: float = 1.0 / 64.0
    stall_s: float = 0.0002
    kill_after: Optional[int] = None
    burst: int = 0
    inner: str = "relic"

    def __post_init__(self) -> None:
        for name in ("raise_rate", "stall_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        if self.raise_rate + self.stall_rate > 1.0:
            raise ValueError(
                "raise_rate + stall_rate must not exceed 1 "
                f"(got {self.raise_rate} + {self.stall_rate})")
        if self.stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {self.stall_s!r}")
        if self.kill_after is not None and self.kill_after < 0:
            raise ValueError(
                f"kill_after must be None or >= 0, got {self.kill_after!r}")
        if self.burst < 0:
            raise ValueError(f"burst must be >= 0, got {self.burst!r}")

    @classmethod
    def from_env(cls) -> "ChaosSpec":
        """Parse ``RELIC_CHAOS`` (``key=value`` pairs, comma-separated,
        e.g. ``"seed=7,stall_rate=0.05,stall_s=0.001,inner=relic-pool"``).
        Unset/empty yields the defaults; unknown keys or malformed values
        raise ``ValueError`` (same discipline as every knob in
        ``repro_torch.runtime.config``)."""
        raw = os.environ.get("RELIC_CHAOS")
        if not raw:
            return cls()
        spec = cls()
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"RELIC_CHAOS entries must be key=value, got {part!r}")
            key, _, value = part.partition("=")
            key = key.strip()
            value = value.strip()
            try:
                if key in ("seed", "burst"):
                    spec = replace(spec, **{key: int(value)})
                elif key in ("raise_rate", "stall_rate", "stall_s"):
                    spec = replace(spec, **{key: float(value)})
                elif key == "kill_after":
                    spec = replace(
                        spec,
                        kill_after=None if value == "none" else int(value))
                elif key == "inner":
                    spec = replace(spec, inner=value)
                else:
                    raise ValueError(
                        f"RELIC_CHAOS: unknown key {key!r}")
            except ValueError as e:
                if "unknown key" in str(e) or "must be" in str(e):
                    raise
                raise ValueError(
                    f"RELIC_CHAOS: bad value for {key!r}: {value!r}"
                ) from None
        return spec


class FaultPlan:
    """The seeded per-task fault stream for one scheduler instance.

    ``decorate(fn)`` draws exactly one uniform variate per task — in
    submission order, from a private ``Random(spec.seed)`` — and returns
    either ``fn`` itself (the common case: zero wrapping, zero overhead
    downstream), a *stall* wrapper (sleeps ``stall_s`` then runs ``fn``,
    preserving its result and exceptions), or a *raise* stub (replaces the
    task with :class:`ChaosInjectedError`; only specs that opted into
    ``raise_rate > 0`` see these). Counters record what was injected so
    tests can assert against the plan rather than re-deriving it.
    """

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self._rng = random.Random(spec.seed)
        self.injected_raises = 0
        self.injected_stalls = 0

    def decorate(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        r = self._rng.random()
        spec = self.spec
        if r < spec.raise_rate:
            self.injected_raises += 1
            idx = self.injected_raises

            def chaos_raise(*args: Any, **kwargs: Any) -> Any:
                raise ChaosInjectedError(f"injected task fault #{idx}")

            return chaos_raise
        if r < spec.raise_rate + spec.stall_rate:
            self.injected_stalls += 1
            stall = spec.stall_s

            def chaos_stall(*args: Any, **kwargs: Any) -> Any:
                time.sleep(stall)
                return fn(*args, **kwargs)

            return chaos_stall
        return fn


def plan_bursts(spec: ChaosSpec, total: int) -> List[int]:
    """Deterministic admission-burst sizes summing to ``total``: the
    seeded shape a bursty client drives the serve layer with (each burst
    uniform in ``[1, spec.burst]``; ``burst=0`` degrades to one-by-one).
    A separate stream from :class:`FaultPlan` (``seed + 1``) so bursting a
    workload does not shift its task-fault placement."""
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    if spec.burst <= 1:
        return [1] * total
    rng = random.Random(spec.seed + 1)
    out: List[int] = []
    left = total
    while left > 0:
        n = min(left, rng.randint(1, spec.burst))
        out.append(n)
        left -= n
    return out


class KillSwitch:
    """Arms ``Relic``'s opt-in assistant-kill hook (``_chaos_kill``).

    The hook is a ``None``-checked callable the assistant loop consults
    once per drained burst, *after* popping it and *before* executing it —
    so firing kills the thread with the popped burst unexecuted and the
    deterministic lost count is exactly ``submitted - completed`` at the
    moment of death (what :class:`repro_torch.core.relic_pool.LaneFailure`
    asserts). ``after_bursts`` bursts are allowed through first; the
    switch records what it did (``fired``, ``lost_tasks``) for tests."""

    def __init__(self, after_bursts: int = 0):
        if after_bursts < 0:
            raise ValueError(
                f"after_bursts must be >= 0, got {after_bursts}")
        self.after_bursts = after_bursts
        self.fired = False
        self.lost_tasks = 0
        self._seen = 0

    def __call__(self, batch_tasks: int) -> bool:
        if self.fired:
            return True
        if self._seen >= self.after_bursts:
            self.fired = True
            self.lost_tasks = batch_tasks
            return True
        self._seen += 1
        return False

    def arm(self, relic: Any) -> "KillSwitch":
        """Attach to a ``Relic`` (or a pool lane). The hook field is part
        of the runtime's test surface: a plain attribute, ``None`` in
        production, checked once per drained burst off the hot path."""
        relic._chaos_kill = self
        return self


class StageKillSwitch:
    """Arms a stream stage's opt-in loop-kill hook (``Stage._chaos_kill``).

    The :class:`KillSwitch` analogue for stream loop tasks: the stage's
    ``_run_loop`` consults the hook once per popped data item, *before*
    applying ``fn`` and before counting the item — so firing kills the
    loop (via ``SystemExit``, the "assistant died" escape class) with the
    popped item unprocessed, and the lost in-flight set is exactly what
    the dealt-minus-released accounting in ``stream/farm.py`` reports.
    ``after_items`` items are allowed through first. Records what it did
    (``fired``, ``fired_t``, ``killed_after``) for detection-latency
    measurements and test assertions.
    """

    def __init__(self, after_items: int = 0):
        if after_items < 0:
            raise ValueError(
                f"after_items must be >= 0, got {after_items}")
        self.after_items = after_items
        self.fired = False
        self.fired_t = 0.0
        self.killed_after = 0

    def __call__(self, items_seen: int) -> bool:
        if self.fired:
            return True
        if items_seen >= self.after_items:
            self.fired = True
            self.fired_t = time.perf_counter()
            self.killed_after = items_seen
            return True
        return False

    def arm(self, stage: Any) -> "StageKillSwitch":
        """Attach to a ``repro_torch.stream.Stage`` (e.g. a farm worker). Same
        surface discipline as ``KillSwitch.arm``: a plain attribute,
        ``None`` in production, checked once per popped item."""
        stage._chaos_kill = self
        return self


class FsCrash(BaseException):
    """A simulated process death during a filesystem write.

    Deliberately **not** an ``Exception``: a real crash does not unwind
    into a task-level error handler, so the injector's escape must take
    the same route a killed thread takes — through a stream stage it kills
    the loop task ("save worker died mid-write"), through a synchronous
    save it propagates to the caller, and in both cases it leaves whatever
    partial on-disk state the chosen crash point implies.
    """


class FsFaultInjector:
    """Deterministic filesystem fault injection for ``CheckpointManager``.

    Armed via ``arm(mgr)`` (sets the manager's ``None``-checked
    ``_chaos_fs`` hook), the injector counts saves as they serialize and
    crashes the ``at_save``-th one (0-based) at a named point:

    * ``"serialize-start"`` — before anything is written (tmp dir empty);
    * ``"entry"`` — after ``at_index`` entry files are fully written, with
      the last one optionally truncated to ``torn_bytes`` (a mid-file
      kill) — tmp dir partially populated, no manifest;
    * ``"manifest"`` — mid-``manifest.json`` write: the first
      ``torn_bytes`` bytes land (default: half), then the crash — the
      torn-manifest case ``latest_step`` must skip-and-warn on;
    * ``"pre-publish"`` — serialization complete, crash before the atomic
      rename: a fully-formed ``.tmp`` dir that never becomes a step.

    Records ``fired`` / ``fired_at`` ``(point, save_index, step)`` so
    tests assert against what actually happened, not the plan.
    """

    POINTS = ("serialize-start", "entry", "manifest", "pre-publish")

    def __init__(self, crash_point: Optional[str] = None, at_save: int = 0,
                 at_index: int = 0, torn_bytes: Optional[int] = None):
        if crash_point is not None and crash_point not in self.POINTS:
            raise ValueError(
                f"crash_point must be one of {self.POINTS}, "
                f"got {crash_point!r}")
        if at_save < 0:
            raise ValueError(f"at_save must be >= 0, got {at_save}")
        if at_index < 0:
            raise ValueError(f"at_index must be >= 0, got {at_index}")
        if torn_bytes is not None and torn_bytes < 0:
            raise ValueError(
                f"torn_bytes must be None or >= 0, got {torn_bytes}")
        self.crash_point = crash_point
        self.at_save = at_save
        self.at_index = at_index
        self.torn_bytes = torn_bytes
        self.fired = False
        self.fired_at: Optional[Tuple[str, int, int]] = None
        self._save = -1       # bumped at each serialize-start
        self._entries = 0

    def arm(self, mgr: Any) -> "FsFaultInjector":
        """Attach to a ``CheckpointManager``. Same test-surface discipline
        as the kill switches: a plain ``_chaos_fs`` attribute, ``None`` in
        production, consulted at the named write points."""
        mgr._chaos_fs = self
        return self

    def _fire(self, point: str, step: int) -> None:
        self.fired = True
        self.fired_at = (point, self._save, step)
        raise FsCrash(
            f"chaos: simulated crash at {point!r} (save #{self._save}, "
            f"step {step})")

    def _armed(self, point: str) -> bool:
        return (not self.fired and self.crash_point == point
                and self._save == self.at_save)

    def at(self, point: str, step: int) -> None:
        """Crash-point probe (called by the manager's write path)."""
        if point == "serialize-start":
            self._save += 1
            self._entries = 0
        if self._armed(point):
            self._fire(point, step)

    def entry_written(self, path: Any, step: int) -> None:
        """Per-entry-file probe; fires after ``at_index`` complete files,
        truncating the last one to ``torn_bytes`` first (mid-file kill)."""
        if not self._armed("entry"):
            self._entries += 1
            return
        if self._entries < self.at_index:
            self._entries += 1
            return
        if self.torn_bytes is not None:
            data = path.read_bytes()
            path.write_bytes(data[: self.torn_bytes])
        self._fire("entry", step)

    def write_manifest(self, path: Any, text: str, step: int) -> None:
        """Manifest write-through; a ``"manifest"`` crash writes the torn
        prefix and dies, anything else writes the full text."""
        if self._armed("manifest"):
            keep = (len(text) // 2 if self.torn_bytes is None
                    else self.torn_bytes)
            path.write_text(text[:keep])
            self._fire("manifest", step)
        path.write_text(text)


class ChaosScheduler:
    """The ``"chaos"`` substrate: an SPI wrapper injecting a seeded fault
    plan into every task before delegating to an inner registry substrate.

    Pure delegation — lifecycle, misuse classification, stats, hints,
    ``workers``, bounded backpressure are all the inner substrate's own
    (so the conformance suite exercises *its* contract under faults, not a
    re-implementation). Only ``submit``/``submit_many`` add work: one RNG
    draw and (rarely) one closure per task.
    """

    def __init__(self, capacity: Optional[int] = None,
                 spec: Optional[ChaosSpec] = None, **inner_kwargs: Any):
        # Late import: the registry lives in schedulers.py, which imports
        # the relic family; importing it at module level here would cycle
        # through the registration at its bottom.
        from repro_torch.core.schedulers import make_scheduler
        self.spec = spec if spec is not None else ChaosSpec.from_env()
        self.plan = FaultPlan(self.spec)
        if capacity is not None:
            inner_kwargs.setdefault("capacity", capacity)
        self._inner = make_scheduler(self.spec.inner, **inner_kwargs)

    @property
    def workers(self) -> int:
        return getattr(self._inner, "workers", 1)

    @property
    def _started(self) -> bool:
        # Lifecycle state must stay visible through the wrapper: callers
        # (e.g. run_wavefronts) duck-type on this before borrowing a
        # scheduler, and hiding it would let them adopt an unstarted one.
        return getattr(self._inner, "_started", True)

    @property
    def stats(self) -> Any:
        return self._inner.stats

    def start(self) -> "ChaosScheduler":
        self._inner.start()
        return self

    def submit(self, fn: Callable[..., Any], *args: Any,
               **kwargs: Any) -> None:
        self._inner.submit(self.plan.decorate(fn), *args, **kwargs)

    def submit_many(self, tasks: Iterable[Tuple[Callable[..., Any],
                                                tuple, dict]]) -> None:
        self._inner.submit_many(
            [(self.plan.decorate(fn), args, kwargs)
             for fn, args, kwargs in tasks])

    def wait(self) -> None:
        self._inner.wait()

    def sleep_hint(self) -> None:
        self._inner.sleep_hint()

    def wake_up_hint(self) -> None:
        self._inner.wake_up_hint()

    def close(self) -> None:
        self._inner.close()

    def __enter__(self) -> "ChaosScheduler":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()
