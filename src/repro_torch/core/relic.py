"""Relic host runtime: specialized two-thread fine-grained tasking (paper §VI).

Faithful port of the paper's design to a Python host runtime:

  * exactly two roles — the **main** thread (producer) and one **assistant**
    thread (consumer). The assistant is created and owned by the runtime.
  * the only scheduling structure is a bounded SPSC ring (capacity 128);
    no work stealing, no priorities, no dynamic load balancing.
  * task submission is only legal from the main thread; the assistant cannot
    submit (recursive task creation is unsupported, exactly as in the paper).
  * waiting is busy-wait first (paper §VI-B: spinning wins for short waits in
    lightly-contended two-thread settings), with explicit developer-driven
    ``wake_up_hint()`` / ``sleep_hint()`` to park the assistant across long
    serial sections instead of a hybrid spin-then-sleep heuristic.

On TPU the same schedule is realized by the DMA/compute lanes inside the
Pallas kernels (see ``repro_torch.kernels.relic_matmul``) and by the ppermute ring
in ``repro_torch.core.collective_matmul``; this module is the host-scale instance,
used by the data pipeline and the async checkpoint manager.

CPython note (recorded in docs/schedulers.md): overlap is only real for tasks that
release the GIL (JAX dispatch/compute, NumPy kernels, file I/O). That matches
the paper's scope — Relic targets *parallelizable sections*, and the hints
exist precisely because the rest of the application is serial.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

from repro_torch.core.spsc import DEFAULT_CAPACITY, SpscRing

# Task protocol: the ring carries bare ``fn, args`` pairs striped across two
# slots (``push2``/flattened ``push_many``) — no per-task wrapper object, so
# a submit allocates nothing beyond what the call protocol already built.
# Keyword arguments (rare on a µs-scale hot path) are folded into ``fn`` via
# ``functools.partial`` before the push. Both counters therefore always
# advance by even amounts, and every drained burst has even length.


class RelicUsageError(RuntimeError):
    """Raised on API misuse (e.g. submit from the assistant thread)."""


class RelicDeadError(RuntimeError):
    """The assistant thread died with work outstanding.

    Raised by the producer's bounded-wait liveness probes (``_barrier``,
    ``_push_spin``, ``_push_flat`` check ``assistant.is_alive()`` every
    ``_PROBE_EVERY_SPINS`` spin rounds when ``RELIC_SUPERVISE`` is on)
    instead of spinning forever on a counter that can no longer advance.
    Carries the diagnostics a supervisor needs: which lane, how many tasks
    were submitted/completed, and how many in-flight tasks are lost with
    the dead consumer. See docs/robustness.md for the failure model.
    """

    def __init__(self, lane: str, submitted: int, completed: int,
                 lost: int) -> None:
        super().__init__(
            f"assistant thread {lane!r} is dead: submitted={submitted} "
            f"completed={completed} lost={lost} (in-flight tasks on a ring "
            "nothing will ever drain)")
        self.lane = lane
        self.submitted = submitted
        self.completed = completed
        self.lost = lost


def flatten_tasks(
    tasks: Iterable[Tuple[Callable[..., Any], tuple, dict]]
) -> list:
    """Flatten ``(fn, args, kwargs)`` triples into the ring's ``fn, args``
    pair stripe (kwargs fold into a ``functools.partial``) — THE task wire
    format both the pair and the pool push and every assistant pops; keep
    it in exactly one place."""
    flat: list = []
    append = flat.append
    for fn, args, kwargs in tasks:
        if kwargs:
            fn = functools.partial(fn, **kwargs)
        append(fn)
        append(args)
    return flat


@dataclass
class RelicStats:
    """Counters for observability; all updated on the owning thread only."""

    submitted: int = 0
    completed: int = 0
    producer_full_spins: int = 0     # times submit() found the ring full
    assistant_empty_spins: int = 0   # assistant poll iterations that found no work
    parks: int = 0                   # times the assistant actually parked
    task_errors: int = 0
    last_error: Optional[BaseException] = field(default=None, repr=False)
    # Submission index (0-based, per runtime) of the task behind
    # ``last_error`` — how RelicPool orders first-errors across lanes.
    # ``first_error_index`` counts primary-ring completions; when the
    # failed task arrived through the handoff (overflow) ring instead,
    # ``first_error_handoff_index`` is set (counting handoff completions)
    # and ``first_error_index`` stays None. Exactly one is non-None while
    # ``last_error`` is pending; both clear with it (see ``_take_error``).
    first_error_index: Optional[int] = None
    first_error_handoff_index: Optional[int] = None


# Spin-cadence resolution lives with the other env-var knobs in
# ``repro_torch.runtime.config``; re-exported here because this module is where
# callers (tests, benchmarks, docs) historically found it.
from repro_torch.runtime.config import (_default_spin_yield,
                                  resolve_spin_pause_every,
                                  resolve_supervise_config)

SPIN_PAUSE_EVERY = _default_spin_yield()

# Liveness-probe cadence for the producer's spin loops: one
# ``Thread.is_alive()`` read per this many spin rounds. Spin rounds are
# sub-microsecond, so detection latency stays well under a millisecond
# while the probe cost is amortized to noise; the clean fast paths
# (submit-with-room, the assistant drain) never reach a probe at all.
_PROBE_EVERY_SPINS = 1024


class Relic:
    """The Relic runtime: one producer (main) + one assistant (consumer).

    Usage::

        rt = Relic()
        rt.start()
        rt.wake_up_hint()          # before a parallelizable section
        rt.submit(fn, a, b)        # main thread only
        ...                        # main thread does its own half of the work
        rt.wait()                  # barrier for all submitted tasks
        rt.sleep_hint()            # after the section
        rt.shutdown()
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, start_awake: bool = False,
                 name: str = "relic-assistant", handoff: bool = False):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        # Two ring slots per task (the fn, args stripe — see the task
        # protocol note above), so `capacity` stays a task count.
        self._ring = SpscRing(2 * capacity)
        self._push2 = self._ring.push2      # pre-bound: the submit hot path
        # Optional victim-cooperative handoff ring (RelicPool rebalancing):
        # a second, equally-bounded SPSC ring the *pool producer* fills only
        # when this lane's primary is backed up, and the assistant drains
        # only when the primary is empty. Still strictly 1P1C per ring —
        # same producer thread, same consumer thread, two rings. The plain
        # pair never allocates it and keeps its original assistant loop.
        self._oring: Optional[SpscRing] = SpscRing(2 * capacity) if handoff else None
        self._name = name                   # assistant thread name (pool lanes)
        self._spin_pause_every = resolve_spin_pause_every()
        # Bounded waits (PR 8): with RELIC_SUPERVISE on (the default) the
        # producer's spin loops probe assistant liveness every
        # _PROBE_EVERY_SPINS rounds and raise RelicDeadError instead of
        # hanging; 0 disables every probe (the pre-supervision spins).
        self._probe_every = (_PROBE_EVERY_SPINS
                             if resolve_supervise_config().supervise else 0)
        # Opt-in chaos hook (repro_torch.runtime.chaos): when set, the assistant
        # calls it once per drained burst (with the burst's task count) and
        # exits abruptly — simulated thread death — when it returns True.
        # None for every production instance: the cost on a live assistant
        # is one attribute load + is-None branch per *burst*, off the
        # per-task hot path.
        self._chaos_kill: Optional[Callable[[int], bool]] = None
        self.stats = RelicStats()
        self._completed = 0              # written by assistant only (both rings)
        self._completed_ovf = 0          # handoff-ring completions only
        self._shutdown = False
        self._awake = threading.Event()  # wake_up_hint/sleep_hint state
        if start_awake:
            self._awake.set()
        self._assistant: Optional[threading.Thread] = None
        self._main_ident: Optional[int] = None

    # ------------------------------------------------------------------ roles

    def start(self) -> "Relic":
        if self._assistant is not None:
            raise RelicUsageError("Relic runtime already started")
        self._main_ident = threading.get_ident()
        target = (self._assistant_loop if self._oring is None
                  else self._assistant_loop_handoff)
        self._assistant = threading.Thread(
            target=target, name=self._name, daemon=True
        )
        self._assistant.start()
        return self

    def _check_main(self, what: str) -> None:
        ident = threading.get_ident()
        if self._assistant is not None and ident == self._assistant.ident:
            # Paper §VI-A: "The assistant thread cannot submit tasks, hence,
            # creating tasks recursively is not supported in Relic."
            raise RelicUsageError(f"{what} called from the assistant thread")
        if self._main_ident is not None and ident != self._main_ident:
            raise RelicUsageError(
                f"{what} must be called from the main (producer) thread"
            )

    # ------------------------------------------------------------- public API

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        """Submit a fine-grained task (main thread only). Busy-waits if full.

        Allocation-free: the hot path pushes the ``fn, args`` pair the call
        protocol already built straight into two ring slots (§VI: expressing
        a task must be nearly free). Keyword arguments take the rare
        ``functools.partial`` fold."""
        if threading.get_ident() != self._main_ident:
            self._check_main("submit()")   # slow path: classify the misuse
        if self._shutdown:
            raise RelicUsageError("submit() after shutdown")
        if kwargs:
            fn = functools.partial(fn, **kwargs)
        # Account after the hand-off (not before): an interrupt unwinding
        # the full-ring spin must not strand submitted > pushed, which
        # would wedge every later wait() (see submit_batch).
        if self._push2(fn, args):
            self.stats.submitted += 1
            return
        self._push_spin(fn, args)
        self.stats.submitted += 1

    def submit_batch(
        self, tasks: Iterable[Tuple[Callable[..., Any], tuple, dict]]
    ) -> None:
        """Submit a burst of ``(fn, args, kwargs)`` tasks (main thread only).

        One role check covers the whole burst, which is flattened into the
        ring's pair stripe and handed off by ``push_many`` — a single
        ``_tail`` store per sub-burst. Busy-waits (ring backpressure)
        whenever the burst outsizes the free slots. Accounting is
        committed as tasks are handed to the ring, not up front, so a
        ``BaseException`` (KeyboardInterrupt) escaping the backpressure
        spin can never strand ``submitted`` above what the assistant will
        ever see — the next ``wait()`` still terminates."""
        if threading.get_ident() != self._main_ident:
            self._check_main("submit_batch()")
        if self._shutdown:
            raise RelicUsageError("submit_batch() after shutdown")
        flat = flatten_tasks(tasks)
        if not flat:
            return
        self._push_flat(flat, account=True)

    def _push_flat(self, flat: Sequence[Any], start: int = 0,
                   stop: Optional[int] = None, account: bool = False) -> None:
        """Hand a pre-flattened ``fn, args`` stripe (``flat[start:stop]``)
        to the ring, busy-waiting under backpressure. Retries advance an
        offset into ``flat`` (push_many's ``start``): a burst far larger
        than the ring spins here, and slicing the remainder per sub-burst
        would be quadratic. ``RelicPool`` pushes each lane's shard of one
        shared flattened burst through this without slicing it either.
        With ``account=True``, ``stats.submitted`` advances with each
        successful sub-push (after it, never before — an interrupt unwinding
        from the spin leaves ``submitted <= pushed``, which can only make a
        later barrier return early by the unaccounted stragglers, never
        busy-spin forever on tasks that were never handed off)."""
        ring = self._ring
        stats = self.stats
        n = len(flat) if stop is None else stop
        pos = start
        pushed = ring.push_many(flat, start, n)
        if pushed:
            pos += pushed
            if account:
                stats.submitted += pushed // 2
        spins = 0
        pause_every = self._spin_pause_every
        probe_every = self._probe_every
        while pos < n:
            if spins == 0:
                # Advisory hints must not deadlock a full-ring burst: the
                # parked assistant is the only possible drain (§VI-B rule).
                self._awake.set()
            stats.producer_full_spins += 1
            spins += 1
            if spins % pause_every == 0:
                time.sleep(0)
            if probe_every and spins % probe_every == 0:
                self._probe_alive()   # a dead consumer never frees a slot
            pushed = ring.push_many(flat, pos, n)
            if pushed:
                pos += pushed
                if account:
                    stats.submitted += pushed // 2
                spins = 0

    def _push_spin(self, fn: Callable[..., Any], args: tuple) -> None:
        """Full-ring slow path for submit(): bounded ring is the backpressure."""
        spins = 0
        pause_every = self._spin_pause_every
        probe_every = self._probe_every
        while not self._push2(fn, args):
            if spins == 0:
                # Hints are advisory (§VI-B): a full ring with a parked
                # assistant cannot drain, so submission un-parks it. Once
                # is enough — only this (blocked) thread could re-park it.
                self._awake.set()
            self.stats.producer_full_spins += 1
            spins += 1
            if spins % pause_every == 0:
                time.sleep(0)  # the Python analogue of `pause`: yield, no park
            if probe_every and spins % probe_every == 0:
                self._probe_alive()   # a dead consumer never frees a slot

    def wait(self) -> None:
        """Block (busy-wait) until every submitted task has completed."""
        self._check_main("wait()")
        self._barrier()
        err = self._take_error()
        if err is not None:
            raise err

    def is_alive(self) -> bool:
        """True while the assistant thread can still make progress: not yet
        started, or started and its thread is alive. (After a clean
        ``shutdown`` the assistant reference is dropped and this is True
        again — a shut-down runtime is not *dead*, it is closed.)"""
        a = self._assistant
        return a is None or a.is_alive()

    def _probe_alive(self) -> None:
        """Liveness probe for the producer's spin loops: raise
        ``RelicDeadError`` if the assistant thread died. Once dead its
        ``_completed`` counter is final, so the lost count (submitted but
        never-to-complete tasks) is deterministic at the raise."""
        a = self._assistant
        if a is None or a.is_alive():
            return
        submitted = self.stats.submitted
        completed = self._completed
        if submitted - completed <= 0:
            # The assistant finished everything before dying: the caller's
            # spin condition will observe that on its next check (a dead
            # counter is final — nothing is lost, nothing can hang).
            return
        raise RelicDeadError(self._name, submitted, completed,
                             submitted - completed)

    def _barrier(self) -> None:
        """The spin half of ``wait()``: block until every submitted task
        completed. RelicPool barriers each lane through this so it can map
        lane-local error indexes to pool-global submission order *before*
        the error state is consumed. Raises nothing — except
        ``RelicDeadError`` when supervision is on and the assistant thread
        died with the barrier outstanding (the wait-liveness contract,
        docs/schedulers.md): spinning on a counter whose only writer is
        gone would never return."""
        target = self.stats.submitted
        if self._completed < target:
            # Advisory hints must not deadlock the barrier: outstanding
            # work with a parked assistant un-parks it (callers that want
            # the assistant parked re-issue sleep_hint() after waiting).
            self._awake.set()
        spins = 0
        pause_every = self._spin_pause_every
        probe_every = self._probe_every
        while self._completed < target:
            spins += 1
            if spins % pause_every == 0:
                time.sleep(0)
            if probe_every and spins % probe_every == 0:
                self._probe_alive()
        self.stats.completed = self._completed

    def _take_error(self) -> Optional[BaseException]:
        """Consume the pending first error, clearing ``last_error`` AND both
        first-error indexes together. They are one unit of state: clearing
        the error while leaving an index (the pre-PR 6 bug) let
        ``RelicPoolStats.last_error`` and ``_trim_runs`` observe a
        submission index from a dead window."""
        stats = self.stats
        err = stats.last_error
        if err is not None:
            stats.last_error = None
            stats.first_error_index = None
            stats.first_error_handoff_index = None
        return err

    def _completed_main_estimate(self) -> int:
        """Lower bound on *primary-ring* completions, safe to read from the
        producer: the total is read before the handoff count and both only
        grow, so the difference can only undercount (the clamp covers the
        pathological interleaving where many handoff tasks complete between
        the two reads). Exact (== ``_completed``) for a plain pair."""
        total = self._completed
        est = total - self._completed_ovf
        return est if est > 0 else 0

    def wake_up_hint(self) -> None:
        """Developer hint: a parallelizable section is imminent (paper §VI-B)."""
        self._awake.set()

    def sleep_hint(self) -> None:
        """Developer hint: no tasks for a while; assistant may park."""
        self._awake.clear()

    def shutdown(self, timeout: float = 5.0) -> None:
        if self._assistant is None:
            return
        self._shutdown = True
        self._awake.set()  # release a parked assistant so it can observe shutdown
        self._assistant.join(timeout)
        if self._assistant.is_alive():
            # The join expired: the assistant is wedged in a task. Dropping
            # the reference here would let a later start() spawn a SECOND
            # consumer on the SPSC ring (single-consumer invariant broken).
            # Keep the live thread, stay shut down (submit keeps raising,
            # start() keeps raising "already started"): non-restartable.
            raise RelicUsageError(
                f"shutdown(): assistant did not exit within {timeout}s "
                "(wedged task?); runtime left in a non-restartable state"
            )
        self._assistant = None

    # ---------------------------------------------------------- assistant side

    def _assistant_loop(self) -> None:
        ring = self._ring
        stats = self.stats
        pop_many = ring.pop_many
        spins = 0
        pause_every = self._spin_pause_every
        while True:
            # Drain the whole burst before re-checking hints or shutdown: one
            # _head publication per burst (pop_many), not one per task. The
            # drain must stay unbounded — every producer publication is a
            # whole number of fn,args pairs, so an unbounded pop keeps the
            # stripe aligned (an odd max_items could split a pair).
            batch = pop_many()
            if not batch:
                if self._shutdown:
                    return
                if not self._awake.is_set():
                    # sleep_hint() was given: park on the event (OS suspension)
                    # instead of burning the core. wake_up_hint() releases us.
                    stats.parks += 1
                    self._awake.wait()
                    continue
                stats.assistant_empty_spins += 1
                spins += 1
                if spins % pause_every == 0:
                    time.sleep(0)  # `pause`-like: yield the GIL, stay runnable
                continue
            spins = 0
            if self._chaos_kill is not None and self._chaos_kill(len(batch) // 2):
                return  # injected thread death: the popped burst is lost
            completed = self._completed    # assistant-only writer: no race
            for i in range(0, len(batch), 2):
                try:
                    batch[i](*batch[i + 1])
                except BaseException as e:  # surfaced at the next wait()
                    stats.task_errors += 1
                    if stats.last_error is None:
                        # First error wins (the SPI contract shared by every
                        # substrate — see docs/schedulers.md); later failures
                        # only bump task_errors. The submission index lets
                        # RelicPool order first-errors across lanes.
                        stats.first_error_index = completed
                        stats.last_error = e
                # Atomic per-task publication of completion (store of a
                # local, not a read-modify-write) so the producer's barrier
                # observes progress early.
                completed += 1
                self._completed = completed

    def _assistant_loop_handoff(self) -> None:
        """Assistant loop for a lane with a handoff ring (RelicPool
        rebalancing). Identical to ``_assistant_loop`` except: when the
        primary ring is empty, the assistant pulls from its handoff ring
        before parking/spinning — the victim-cooperative half of the
        pool's skew resistance. Primary work always drains first, so the
        lane's own FIFO is untouched; handoff tasks run at lane-idle
        priority, each ring still strictly one-producer/one-consumer.
        Kept as a separate loop so the plain pair's drain stays
        byte-for-byte the paper's two-thread hot path."""
        ring = self._ring
        oring = self._oring
        stats = self.stats
        pop_many = ring.pop_many
        opop_many = oring.pop_many
        spins = 0
        pause_every = self._spin_pause_every
        ovf_poll_every = 8  # idle iterations between overflow-ring polls
        ovf_countdown = 1   # first idle pass polls immediately
        c_main = 0      # primary-ring completions (local; assistant-only)
        c_ovf = 0       # handoff-ring completions
        while True:
            from_ovf = False
            batch = pop_many()
            if not batch:
                # Primary idle: help with handed-off (rebalanced) work.
                # An empty-ring pop still pays a cross-thread index read,
                # so the steady-state idle spin polls the handoff ring
                # only every few iterations (it is the lane's *cold* path
                # by construction — the producer fills it only when
                # primaries are backed up). Shutdown and park force the
                # poll: both must observe a drained handoff ring first.
                ovf_countdown -= 1
                if (ovf_countdown <= 0 or self._shutdown
                        or not self._awake.is_set()):
                    ovf_countdown = ovf_poll_every
                    batch = opop_many()
                    from_ovf = True
                if not batch:
                    if self._shutdown:
                        return          # both rings drained
                    if not self._awake.is_set():
                        stats.parks += 1
                        self._awake.wait()
                        continue
                    stats.assistant_empty_spins += 1
                    spins += 1
                    if spins % pause_every == 0:
                        time.sleep(0)
                    continue
            spins = 0
            if self._chaos_kill is not None and self._chaos_kill(len(batch) // 2):
                return  # injected thread death: the popped burst is lost
            for i in range(0, len(batch), 2):
                try:
                    batch[i](*batch[i + 1])
                except BaseException as e:
                    stats.task_errors += 1
                    if stats.last_error is None:
                        # First error wins, as in the primary loop; which
                        # ring carried the task decides which index field
                        # RelicPool maps through (seq log vs handoff log).
                        if from_ovf:
                            stats.first_error_handoff_index = c_ovf
                        else:
                            stats.first_error_index = c_main
                        stats.last_error = e
                if from_ovf:
                    c_ovf += 1
                    # Publication order matters for _trim_runs' racy reads:
                    # _completed_ovf first, then the total — a reader that
                    # takes the total first and the ovf count second can
                    # only *under*count primary completions (total - ovf),
                    # so seq-log trimming stays conservative.
                    self._completed_ovf = c_ovf
                else:
                    c_main += 1
                self._completed = c_main + c_ovf

    # ------------------------------------------------------------- context mgr

    def __enter__(self) -> "Relic":
        return self.start()

    def __exit__(self, exc_type: Any, *exc: Any) -> None:
        try:
            self.shutdown()
        except RelicUsageError:
            # A wedged-assistant shutdown is worth raising on a clean exit,
            # but must never mask the body's own in-flight exception.
            if exc_type is None:
                raise
