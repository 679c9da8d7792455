"""Swappable host scheduling substrates behind one ``Scheduler`` contract.

The paper's central experiment is a head-to-head comparison of *scheduling
structures* — Relic's busy-wait SPSC ring against lock-based spinning,
condition-variable suspension, and general thread pools — on a fixed task
stream. This module makes those competitors first-class citizens of the
runtime instead of throwaway benchmark classes, so every consumer (data
pipeline, async checkpointing, the wavefront task driver, benchmarks, and
the conformance suite) can swap substrates by name.

Substrate-to-paper-framework mapping (see docs/schedulers.md):

  ==========  =====================================  =======================
  name        structure                              paper framework flavour
  ==========  =====================================  =======================
  serial      run inline on the producer thread      the serial baseline
  relic       busy-wait SPSC ring, fixed roles       Relic (the paper's §VI)
  relic-pool  N lanes, each its own SPSC ring +      Relic scaled past the
              assistant; lane-striped submission     SMT pair (lanes=N)
  relic2/4    relic-pool at lanes=2 / lanes=4        convenience names
  spin        mutex-protected deque + spin waits     X-OpenMP (lock + spin)
  condvar     bounded queue, condvar suspension      GNU OpenMP (suspension)
  pool        general thread pool + futures          oneTBB / Taskflow
  chaos       fault-injecting wrapper over any of    the chaos harness
              the above (repro_torch.runtime.chaos)        (robustness testing)
  ==========  =====================================  =======================

The observable contract (enforced by tests/test_schedulers_conformance.py):

  * ``start()`` before any ``submit()``; returns ``self``; double-start
    raises. ``close()`` is idempotent, safe without ``start()``, and drains
    in-flight tasks before returning.
  * ``submit(fn, *args, **kwargs)`` enqueues a task; every substrate is
    bounded by ``capacity`` and backpressures (blocks) when full — tasks
    are never dropped. Burst-draining workers (relic, condvar) may hold
    up to one drained burst (≤ ``capacity`` tasks) in flight on top of
    the full queue, so the worst-case submitted-but-unfinished count is
    2×``capacity``, a constant — never unbounded growth.
  * ``submit_many(tasks)`` enqueues a burst of ``(fn, args, kwargs)``
    tuples with the same ordering, bounding, and error semantics as the
    equivalent ``submit()`` loop. The base class provides exactly that
    loop as the fallback (third-party substrates inherit it for free);
    relic/spin/condvar override it with native batch paths that pay one
    role-check/lock/counter-publication per burst instead of per task.
  * ``wait()`` blocks until every task submitted so far has completed. If
    any task raised since the last ``wait()``, the first such exception is
    re-raised there (and cleared); the scheduler stays usable.
  * ``sleep_hint()`` / ``wake_up_hint()`` are advisory (paper §VI-B): they
    may park/unpark a spinning worker and are no-ops for substrates that
    already suspend when idle.
  * ``stats`` exposes at least ``submitted``, ``completed``,
    ``task_errors``, and ``last_error``.
  * ``workers`` (optional, defaulting to 1 via ``getattr`` at use sites)
    advertises how many worker threads can run tasks concurrently —
    0 for serial (inline), 1 for the single-assistant substrates, N for
    pools. Consumers like ``repro_torch.tasks.api.parallel_for`` derive their
    default grain from it; global FIFO is only guaranteed when
    ``workers <= 1``.

``submit()``/``wait()`` are owning-thread-only, mirroring Relic's
no-recursive-spawn rule (paper §VI-A): a task may not submit more tasks.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Protocol,
                    Tuple, runtime_checkable)

from repro_torch.core.relic import (Relic, RelicUsageError,
                              resolve_spin_pause_every)
from repro_torch.core.relic_pool import RelicPool
from repro_torch.core.spsc import DEFAULT_CAPACITY

__all__ = [
    "Scheduler",
    "SchedulerStats",
    "SchedulerUsageError",
    "SerialScheduler",
    "RelicScheduler",
    "RelicPoolScheduler",
    "SpinQueueScheduler",
    "CondvarQueueScheduler",
    "PoolScheduler",
    "ChaosScheduler",
    "available_schedulers",
    "make_scheduler",
    "register_scheduler",
]


class SchedulerUsageError(RuntimeError):
    """Raised on contract misuse (submit after close, double start, ...)."""


# Relic predates this module and raises its own error type; both satisfy
# the "misuse raises" clause of the contract.
USAGE_ERRORS = (SchedulerUsageError, RelicUsageError)


@dataclass
class SchedulerStats:
    """Minimal counter surface every substrate exposes (Relic's superset
    of these counters in ``RelicStats`` is duck-compatible)."""

    submitted: int = 0
    completed: int = 0
    task_errors: int = 0
    last_error: Optional[BaseException] = field(default=None, repr=False)


@runtime_checkable
class Scheduler(Protocol):
    """Structural type for a host scheduling substrate."""

    def start(self) -> "Scheduler": ...
    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None: ...
    def submit_many(self, tasks: Iterable[Tuple[Callable[..., Any],
                                                tuple, dict]]) -> None: ...
    def wait(self) -> None: ...
    def sleep_hint(self) -> None: ...
    def wake_up_hint(self) -> None: ...
    def close(self) -> None: ...

    @property
    def stats(self) -> SchedulerStats: ...


# --------------------------------------------------------------------- registry

_REGISTRY: Dict[str, Callable[..., "Scheduler"]] = {}


def register_scheduler(name: str):
    """Class decorator registering a substrate under ``name`` (mirrors
    ``models/registry.py``: one flat name -> factory map)."""

    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def available_schedulers() -> List[str]:
    """Registered substrate names, stable order."""
    return sorted(_REGISTRY)


def make_scheduler(name: str, **kwargs: Any) -> "Scheduler":
    """Instantiate a substrate by name (not started)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; available: {available_schedulers()}"
        ) from None
    return factory(**kwargs)


# ------------------------------------------------------------------ base class

class _SchedulerBase:
    """Shared plumbing: owning-thread checks, lifecycle flags, hints."""

    # Advertised concurrent-worker count (the optional SPI property):
    # how many worker threads can run tasks at once. 1 is the SPI-wide
    # default (a single assistant/worker); serial overrides with 0 and
    # pools with their lane/thread count. ``repro_torch.tasks.api`` reads it
    # via getattr so borrowed third-party substrates need not have it.
    workers: int = 1

    def __init__(self) -> None:
        self.stats = SchedulerStats()
        self._started = False
        self._closed = False
        self._owner: Optional[int] = None

    # lifecycle ------------------------------------------------------------
    def start(self) -> "Scheduler":
        if self._started:
            raise SchedulerUsageError(f"{type(self).__name__} already started")
        self._started = True
        self._closed = False
        self._owner = threading.get_ident()
        self._start_impl()
        return self

    def close(self) -> None:
        if not self._started or self._closed:
            self._closed = True
            return
        self._closed = True
        self._close_impl()

    def _start_impl(self) -> None:  # pragma: no cover - trivial default
        pass

    def _close_impl(self) -> None:  # pragma: no cover - trivial default
        pass

    # batch submission: the SPI-wide fallback is the equivalent submit()
    # loop, so any substrate (including third-party registrations) honours
    # submit_many; relic/spin/condvar override with native batch paths.
    def submit_many(self, tasks: Iterable[Tuple[Callable[..., Any],
                                                tuple, dict]]) -> None:
        for fn, args, kwargs in tasks:
            self.submit(fn, *args, **kwargs)

    # hints: advisory, default no-op (substrates that suspend when idle
    # need no parking; spinning substrates override)
    def sleep_hint(self) -> None:
        pass

    def wake_up_hint(self) -> None:
        pass

    # helpers --------------------------------------------------------------
    def _check_submit(self, what: str = "submit()") -> None:
        if not self._started:
            raise SchedulerUsageError(f"{what} before start()")
        if self._closed:
            raise SchedulerUsageError(f"{what} after close()")
        if self._owner is not None and threading.get_ident() != self._owner:
            raise SchedulerUsageError(
                f"{what} must be called from the owning (producer) thread"
            )

    def _record_error(self, exc: BaseException) -> None:
        self.stats.task_errors += 1
        if self.stats.last_error is None:
            self.stats.last_error = exc

    def _raise_pending(self) -> None:
        if self.stats.last_error is not None:
            err, self.stats.last_error = self.stats.last_error, None
            raise err

    # context manager ------------------------------------------------------
    def __enter__(self) -> "Scheduler":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ------------------------------------------------------------------ substrates

@register_scheduler("serial")
class SerialScheduler(_SchedulerBase):
    """The paper's baseline: no concurrency, tasks run inline at submit.

    Useful as the control in benchmarks and as the zero-thread fallback
    (e.g. pipelines in environments where spawning threads is undesirable).
    """

    workers = 0        # no worker threads: parallel_for runs fully inline

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__()
        del capacity  # no queue: nothing to bound

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self._check_submit()
        self.stats.submitted += 1
        try:
            fn(*args, **kwargs)
        except BaseException as e:  # surfaced at the next wait()
            self._record_error(e)
        self.stats.completed += 1

    def wait(self) -> None:
        self._raise_pending()


class _RelicAdapterBase(_SchedulerBase):
    """Shared adapter plumbing for the Relic-family runtimes (the pair and
    the pool). Everything here is the non-hot-path boilerplate both
    adapters need verbatim — lifecycle, batch-SPI guards, misuse
    classification, the close()-must-not-raise error stash — factored out
    so a contract change cannot silently diverge the two. Only the merged
    ``submit()`` fast path stays per-adapter (its whole point is being
    inlined against one runtime's internals).

    Subclass ``__init__`` must set ``self._rt`` to the backing runtime:
    anything exposing ``start``/``submit_batch``/``wait``/``sleep_hint``/
    ``wake_up_hint``/``shutdown``/``_check_main`` and a ``stats`` object
    whose ``last_error`` is assignable (``RelicStats`` field /
    ``RelicPoolStats`` setter)."""

    _rt: Any

    @property  # type: ignore[override]
    def stats(self):
        return self._rt.stats

    @stats.setter
    def stats(self, value):  # _SchedulerBase.__init__ assigns; ignore it
        pass

    def _start_impl(self) -> None:
        self._rt.start()

    def submit_many(self, tasks: Iterable[Tuple[Callable[..., Any],
                                                tuple, dict]]) -> None:
        if not self._started:
            raise SchedulerUsageError("submit_many() before start()")
        if self._closed:
            raise SchedulerUsageError("submit_many() after close()")
        self._rt.submit_batch(tasks)

    def _submit_misuse(self, what: str) -> None:
        """Slow path: classify (and raise) the fast-path rejection."""
        if not self._started:
            # The runtime itself would accept this (roles are fixed at
            # start()); the uniform contract says it must raise, like
            # every substrate.
            raise SchedulerUsageError(f"{what} before start()")
        if self._closed:
            raise SchedulerUsageError(f"{what} after close()")
        self._rt._check_main(what)         # wrong thread (incl. assistants)
        raise SchedulerUsageError(f"{what} after shutdown")

    def wait(self) -> None:
        # The runtimes themselves guarantee advisory hints cannot deadlock
        # the barrier (wait/full-ring submit un-park assistants).
        self._rt.wait()

    def sleep_hint(self) -> None:
        self._rt.sleep_hint()

    def wake_up_hint(self) -> None:
        self._rt.wake_up_hint()

    def _close_impl(self) -> None:
        try:
            # Drain and update counters. close() must not raise, but the
            # error stays observable on stats (RelicStats keeps the field;
            # RelicPoolStats stashes it through its setter).
            self._rt.wait()
        except BaseException as e:
            self._rt.stats.last_error = e
        self._rt.shutdown()


@register_scheduler("relic")
class RelicScheduler(_RelicAdapterBase):
    """The paper's design (§VI): busy-wait SPSC ring, fixed producer and
    assistant roles. Adapter over :class:`repro_torch.core.relic.Relic`;
    ``stats`` is the underlying ``RelicStats`` (a superset of
    ``SchedulerStats`` counters, including spin/park telemetry).

    ``submit()`` is deliberately *not* a thin forwarder: stacking the
    adapter's contract checks on top of ``Relic.submit``'s own (plus a
    second ``*args``/``**kwargs`` splat) costs several hundred ns per
    task — comparable to the ring push itself. The fast path merges both
    layers' checks into one branch and pushes straight into the ring;
    ``_submit_misuse`` re-runs the layered checks only to classify a
    failure. This couples the adapter to Relic internals, which is the
    point of the adapter being *in* the runtime package."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, start_awake: bool = True):
        super().__init__()
        self._rt = self._relic = Relic(capacity=capacity,
                                       start_awake=start_awake)
        # Hot-path pre-binds: one attribute load each per submit, resolved
        # once here instead of chasing the relic -> ring chain per task.
        self._push2 = self._relic._push2
        self._rstats = self._relic.stats

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        # _closed covers relic._shutdown (close() is its only caller), and
        # _owner equals relic's main ident (start() runs on one thread), so
        # three loads + one get_ident() decide the whole contract.
        if (self._closed or not self._started
                or threading.get_ident() != self._owner):
            self._submit_misuse("submit()")
        if kwargs:
            fn = functools.partial(fn, **kwargs)
        # Account after the hand-off, as Relic.submit does (an interrupt
        # unwinding the full-ring spin must not strand submitted > pushed).
        if self._push2(fn, args):
            self._rstats.submitted += 1
            return
        self._relic._push_spin(fn, args)
        self._rstats.submitted += 1


@register_scheduler("relic-pool")
class RelicPoolScheduler(_RelicAdapterBase):
    """Relic scaled past the SMT pair (see ``repro_torch.core.relic_pool``): N
    lanes, each an independent SPSC ring + assistant preserving the exact
    invariants and fast paths of the pair; the producer stripes submissions
    round-robin with a least-loaded fallback and shards ``submit_many``
    bursts across the lanes in one pass. ``stats`` is the live aggregate
    ``RelicPoolStats`` view (``stats.lanes`` has the per-lane detail).

    Like :class:`RelicScheduler`, ``submit()`` is a merged fast path
    rather than a layered forwarder: one branch covers both the adapter's
    and the pool's contract checks, then the pre-bound striped push runs.
    ``capacity`` is **per lane** (each lane is its own bounded ring), so
    the backpressure bound is ``2 × capacity`` per lane — still a
    constant, never unbounded growth.

    Ordering: FIFO holds per lane, not globally (``workers = lanes``);
    callers needing global FIFO use a ``workers <= 1`` substrate.
    Registered as ``relic-pool`` (``lanes=N`` keyword, default 2) with
    convenience names ``relic2`` and ``relic4``.

    ``rebalance`` (default on, multi-lane only) enables the pool's skew
    resistance: producer-side re-striping of stuck burst remainders plus
    per-lane victim-cooperative handoff rings — dynamic load balancing
    that keeps every ring strictly SPSC (see ``repro_torch.core.relic_pool``
    and docs/schedulers.md). ``rebalance=False`` is the PR 5 static
    striping, kept addressable for A/B measurement (the ``skew``
    benchmark section runs both)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, lanes: int = 2,
                 start_awake: bool = True, rebalance: bool = True,
                 respawn: bool = False, supervise: Optional[bool] = None,
                 heartbeat_ms: Optional[float] = None):
        super().__init__()
        self._rt = self._pool = RelicPool(lanes=lanes, capacity=capacity,
                                          start_awake=start_awake,
                                          rebalance=rebalance,
                                          respawn=respawn,
                                          supervise=supervise,
                                          heartbeat_ms=heartbeat_ms)
        # Hot-path pre-bind: the pool's no-checks striped push.
        self._submit2 = self._pool._submit2
        if lanes == 1 and not respawn:
            # Degenerate pool, adapter edition: shadow submit() with a
            # closure whose hot path is byte-for-byte the pair adapter's
            # (free-variable loads, no pool hop) — the lanes=1 scaling
            # rows must measure the pair, not an extra call frame.
            lane0 = self._pool._lane0
            push2 = self._pool._push2_0
            rstats = self._pool._stats0

            def submit_single(fn: Callable[..., Any], *args: Any,
                              **kwargs: Any) -> None:
                if (self._closed or not self._started
                        or threading.get_ident() != self._owner):
                    self._submit_misuse("submit()")
                if kwargs:
                    fn = functools.partial(fn, **kwargs)
                if push2(fn, args):
                    rstats.submitted += 1
                    return
                lane0._push_spin(fn, args)
                rstats.submitted += 1

            self.submit = submit_single    # instance attr shadows the method

    @property
    def workers(self) -> int:  # type: ignore[override]
        return self._pool.n_lanes

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        # Same merged contract check as RelicScheduler: _closed covers
        # pool shutdown (close() is its only caller) and _owner equals the
        # pool's main ident (start() runs on one thread).
        if (self._closed or not self._started
                or threading.get_ident() != self._owner):
            self._submit_misuse("submit()")
        if kwargs:
            fn = functools.partial(fn, **kwargs)
        self._submit2(fn, args)

    # Lane-supervision pass-throughs (PR 8) for fire-and-observe consumers
    # (the serve loop never calls wait(), so it reads lane health here).
    def poll_lane_failures(self):
        """One supervision sweep + drain: quarantine newly dead lanes
        (respawning when configured) and return every not-yet-consumed
        ``LaneFailure``. Owning-thread only."""
        self._pool.check_lanes()
        return self._pool.take_lane_failures()

    def in_flight_estimate(self) -> int:
        return self._pool.in_flight_estimate()

    def stalled_lanes(self):
        return self._pool.stalled_lanes()

    def straggler_lanes(self):
        return self._pool.straggler_lanes()


def _register_pool_convenience(name: str, lanes: int) -> None:
    """Fixed-lane-count convenience names (``relic2``/``relic4``): the same
    ``RelicPoolScheduler``, pre-parameterized, so benchmark matrices and
    ``scheduler=`` strings can name a lane count without kwargs plumbing."""

    def factory(**kwargs: Any) -> RelicPoolScheduler:
        if kwargs.setdefault("lanes", lanes) != lanes:
            # The name IS the lane count: a row or stats dump labelled
            # relic4 must never secretly be a 2-lane pool. Overriding
            # lanes is what the generic "relic-pool" name is for.
            raise ValueError(
                f"{name!r} is fixed at lanes={lanes}; got "
                f"lanes={kwargs['lanes']} (use 'relic-pool' to pick a "
                "lane count)")
        sched = RelicPoolScheduler(**kwargs)
        sched.name = name              # instance attr shadows the class name
        return sched

    _REGISTRY[name] = factory


_register_pool_convenience("relic2", 2)
_register_pool_convenience("relic4", 4)


@register_scheduler("spin")
class SpinQueueScheduler(_SchedulerBase):
    """Persistent worker over a mutex-protected deque with spin waits on
    both sides (the X-OpenMP flavour: lock-based queue + spinning).

    Promoted from the benchmark-private ``_SpinWorker`` and hardened: the
    queue is bounded (backpressure instead of unbounded growth), task
    exceptions are captured and re-raised at ``wait()`` instead of killing
    the worker, and ``sleep_hint()`` actually parks the spinning worker.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__()
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = capacity
        # Per-instance spin/yield cadence (RELIC_SPIN_PAUSE_EVERY aware),
        # same resolution rule as Relic so the spin-vs-relic comparison
        # benchmarks the same yield regime.
        self._spin_pause_every = resolve_spin_pause_every()
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._completed = 0            # worker-only writer
        self._stop = False
        self._awake = threading.Event()
        self._awake.set()
        self._t: Optional[threading.Thread] = None

    def _start_impl(self) -> None:
        self._t = threading.Thread(
            target=self._loop, name=f"{self.name}-worker", daemon=True)
        self._t.start()

    def _loop(self) -> None:
        spins = 0
        pause_every = self._spin_pause_every
        while True:
            item = None
            with self._lock:
                if self._dq:
                    item = self._dq.popleft()
            if item is None:
                if self._stop:
                    return
                if not self._awake.is_set():
                    self._awake.wait()
                    continue
                spins += 1
                if spins % pause_every == 0:
                    time.sleep(0)
                continue
            spins = 0
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except BaseException as e:
                self._record_error(e)
            self._completed += 1

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self._check_submit()
        spins = 0
        while True:
            with self._lock:
                if len(self._dq) < self._capacity:
                    self._dq.append((fn, args, kwargs))
                    break
            if spins == 0:
                # Full queue + parked worker would deadlock this spin:
                # hints are advisory, not fatal — un-park once (only this
                # blocked thread could re-park it).
                self._awake.set()
            spins += 1               # bounded queue: spin until a slot frees
            if spins % self._spin_pause_every == 0:
                time.sleep(0)
        self.stats.submitted += 1

    def submit_many(self, tasks: Iterable[Tuple[Callable[..., Any],
                                                tuple, dict]]) -> None:
        """Native batch path: each lock acquisition moves as many tasks as
        the bounded deque has room for, instead of one."""
        self._check_submit("submit_many()")
        if not isinstance(tasks, (list, tuple)):
            tasks = list(tasks)
        n = len(tasks)
        pos = 0
        spins = 0
        while pos < n:
            with self._lock:
                free = self._capacity - len(self._dq)
                if free > 0:
                    take = min(free, n - pos)
                    self._dq.extend(tasks[pos:pos + take])
                    pos += take
                    self.stats.submitted += take
                    spins = 0
                    continue
            if spins == 0:
                self._awake.set()     # same advisory-hint rule as submit()
            spins += 1
            if spins % self._spin_pause_every == 0:
                time.sleep(0)

    def wait(self) -> None:
        if self._completed < self.stats.submitted:
            # Advisory hints must not deadlock the barrier: un-park the
            # worker (callers wanting it parked re-issue sleep_hint after).
            self._awake.set()
        spins = 0
        pause_every = self._spin_pause_every
        while self._completed < self.stats.submitted:
            spins += 1
            if spins % pause_every == 0:
                time.sleep(0)
        self.stats.completed = self._completed
        self._raise_pending()

    def sleep_hint(self) -> None:
        self._awake.clear()

    def wake_up_hint(self) -> None:
        self._awake.set()

    def _close_impl(self) -> None:
        self._stop = True
        self._awake.set()
        if self._t is not None:
            self._t.join(timeout=5)
            self._t = None
        self.stats.completed = self._completed


@register_scheduler("condvar")
class CondvarQueueScheduler(_SchedulerBase):
    """Persistent worker over a bounded condvar-guarded deque (suspension on
    both sides — the GNU-OpenMP flavour: suspension-based waits). Promoted
    from the benchmark-private ``_CondvarWorker`` and hardened: bounded
    queue, exception capture, idempotent shutdown. The deque+Condition pair
    replaced ``queue.Queue`` so the native ``submit_many`` path can move a
    whole burst per lock acquisition (and the worker can drain one), which
    a ``Queue`` cannot express."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__()
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._done = threading.Semaphore(0)
        self._outstanding = 0
        self._t: Optional[threading.Thread] = None

    def _start_impl(self) -> None:
        self._t = threading.Thread(
            target=self._loop, name=f"{self.name}-worker", daemon=True)
        self._t.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._dq:
                    self._cv.wait()
                # Drain the full burst under one lock acquisition; the None
                # shutdown sentinel is FIFO-last so it ends the final batch.
                batch = list(self._dq)
                self._dq.clear()
                self._cv.notify()         # free a producer blocked on full
            for item in batch:
                if item is None:
                    return
                fn, args, kwargs = item
                try:
                    fn(*args, **kwargs)
                except BaseException as e:
                    self._record_error(e)
                finally:
                    self.stats.completed += 1
                    self._done.release()

    def _put(self, item: Any) -> None:
        with self._cv:
            while len(self._dq) >= self._capacity:
                self._cv.wait()           # blocks when full: backpressure
            self._dq.append(item)
            self._cv.notify()

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self._check_submit()
        self._put((fn, args, kwargs))
        self.stats.submitted += 1
        self._outstanding += 1

    def submit_many(self, tasks: Iterable[Tuple[Callable[..., Any],
                                                tuple, dict]]) -> None:
        """Native batch path: each wakeup hands the worker every task the
        bounded queue has room for, one notify per sub-burst."""
        self._check_submit("submit_many()")
        if not isinstance(tasks, (list, tuple)):
            tasks = list(tasks)
        n = len(tasks)
        pos = 0
        with self._cv:
            while pos < n:
                free = self._capacity - len(self._dq)
                if free <= 0:
                    self._cv.wait()
                    continue
                take = min(free, n - pos)
                self._dq.extend(tasks[pos:pos + take])
                pos += take
                self.stats.submitted += take
                self._outstanding += take
                self._cv.notify()

    def wait(self) -> None:
        for _ in range(self._outstanding):
            self._done.acquire()
        self._outstanding = 0
        self._raise_pending()

    def _close_impl(self) -> None:
        if self._t is not None:
            self._put(None)               # drains FIFO: sentinel is last
            self._t.join(timeout=5)
            self._t = None


@register_scheduler("pool")
class PoolScheduler(_SchedulerBase):
    """General thread pool + futures (the oneTBB/Taskflow flavour): dynamic
    worker assignment, no fixed roles, OS-mediated wakeups. ``capacity``
    bounds the number of in-flight tasks (a semaphore blocks submit when
    full), matching the bounded-backpressure contract of the other
    substrates — without it, consumers like the async checkpoint manager
    could queue unbounded host-memory snapshots."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, workers: int = 2):
        super().__init__()
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._workers = workers
        self._slots = threading.BoundedSemaphore(capacity)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    @property
    def workers(self) -> int:  # type: ignore[override]
        return self._workers

    def _start_impl(self) -> None:
        self._pool = ThreadPoolExecutor(
            max_workers=self._workers, thread_name_prefix=f"{self.name}-worker")

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        self._check_submit()
        assert self._pool is not None
        self._slots.acquire()        # backpressure: block at capacity in flight
        self.stats.submitted += 1
        fut = self._pool.submit(fn, *args, **kwargs)
        fut.add_done_callback(lambda _f: self._slots.release())
        self._pending.append(fut)
        if len(self._pending) >= 4 * self._workers:
            # Consumers like PrefetchPipeline submit forever without ever
            # calling wait(); reap finished futures so _pending stays O(1).
            self._reap(block=False)

    def _reap(self, block: bool) -> None:
        still: List[Future] = []
        for f in self._pending:
            if block or f.done():
                try:
                    f.result()
                except BaseException as e:
                    self._record_error(e)
                self.stats.completed += 1
            else:
                still.append(f)
        self._pending = still

    def wait(self) -> None:
        self._reap(block=True)
        self._raise_pending()

    def _close_impl(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        # every future is done after shutdown(wait=True); record outcomes
        # (close() must not raise — errors stay observable in stats)
        self._reap(block=True)


# Registered last so the registry is complete the moment this module is
# importable: the chaos wrapper lives in repro_torch.runtime.chaos (which must
# not import this module at top level — it resolves make_scheduler lazily)
# and joins the registry here, exactly like the substrates defined above.
from repro_torch.runtime.chaos import ChaosScheduler  # noqa: E402

register_scheduler("chaos")(ChaosScheduler)
