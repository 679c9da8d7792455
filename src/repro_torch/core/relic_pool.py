"""RelicPool: the paper's SMT pair scaled to N lanes (one producer, N assistants).

The paper's Relic is deliberately a *two*-thread runtime — one producer and
one assistant on SMT sibling contexts, joined by a single bounded SPSC ring
(§VI). This module is the repo's first step past that ceiling, following
the FastFlow construction (Aldinucci et al., 2009): lock-free SPSC queues
*compose* into larger networks without giving up the single-producer /
single-consumer fast path. A ``RelicPool`` is N independent **lanes**, each
a full :class:`repro_torch.core.relic.Relic` (its own ``SpscRing`` + assistant
thread + hints + stats), so every lane preserves the exact SPSC invariants
and cached-index/batch fast paths of the pair — no MPMC queue anywhere, no
lock on the submit path.

What the pool adds on top of the lanes:

* **Lane-striped submission.** ``submit()`` round-robins a cursor over the
  lanes; when the target lane's ring is full it tries the other lanes,
  least-loaded first (by the ring's racy-but-monotonic ``len()`` — a
  stale read costs balance, never correctness), and busy-waits *sweeping
  all lanes* only while every ring is full — so a lane wedged behind a
  long task can never block a submission another lane has room for
  (bounded backpressure engages pool-wide, not per-lane).
  ``submit_batch()`` flattens the burst once and deals contiguous shards
  across the lanes — each lane ``push_many``-ing its window of the
  *shared* flattened list (no per-lane slicing) — in two phases: a
  non-blocking pass hands every lane what its ring has room for, then
  the remainders are swept round-robin, so here too a wedged lane never
  starves the shards the other lanes already have room to run.
* **Skew resistance (dynamic load balancing, PR 6).** Static striping
  pins a task to its lane forever — exactly where irregular (power-law
  cost) workloads bleed speedup when one lane wedges behind a long task.
  With ``rebalance=True`` (the default for multi-lane pools) two
  mechanisms fix that without touching any hot path or SPSC invariant:
  (1) *re-striping* — a burst remainder the sweep cannot place in its
  own lane is re-dealt, producer-side, to lanes with room; (2) a
  *victim-cooperative handoff ring* per lane — a second bounded SPSC
  ring the producer fills only when primaries are backed up and the
  lane's assistant drains only when its primary is idle. Every ring
  stays strictly one-producer/one-consumer (the pool's single producer
  pushes, that lane's single assistant pops); there is still no MPMC
  structure and no lock anywhere. ``rebalance=False`` reproduces the
  static PR 5 pool bit-for-bit.
* **Lane supervision & graceful degradation (PR 8).** With
  ``RELIC_SUPERVISE`` on (the default) every producer slow path is a
  *bounded* wait: the spin loops periodically probe assistant liveness,
  so a lane whose thread died is **quarantined** — pulled out of
  striping, its in-flight tasks deterministically accounted as lost
  (:class:`LaneFailure`), the event surfaced at ``wait()`` as
  :class:`LaneFailedError` — instead of hanging the producer forever.
  ``respawn=True`` additionally rebuilds the slot with a fresh lane
  (fresh rings, fresh thread), amending the pair's non-restartable
  contract at pool scope only. A ``LaneSupervisor`` fed from the lanes'
  completion counters flags stalled and straggling lanes as advisory
  telemetry (``stalled_lanes()`` / ``straggler_lanes()``).
* **Broadcast hints.** ``sleep_hint()`` / ``wake_up_hint()`` fan out to
  every lane (paper §VI-B, now meaning "park/unpark the whole pool").
* **Aggregated stats.** ``stats`` is a live view summing the per-lane
  ``RelicStats`` counters; ``stats.lanes`` exposes the per-lane detail
  (striping tests and benchmarks read it).
* **First-error-wins across lanes.** Each lane already keeps its *own*
  first error plus the submission index it happened at; ``wait()`` barriers
  every lane, maps those lane-local indexes back to the pool-global
  submission order (a per-window seq log the producer appends to), and
  re-raises the error of the **earliest-submitted** failed task — the SPI
  contract, extended across lanes. Later failures only bump
  ``task_errors``, exactly as in the pair.

The pair's usage rules apply unchanged: submission and waiting are
main-thread-only, assistants cannot submit (no recursive spawn, §VI-A),
and hints are advisory (they may never deadlock a barrier or a full-ring
submit). A ``lanes=1`` pool is semantically the pair with striping
bookkeeping on top — the ``scaling`` benchmark section records what that
bookkeeping costs (it must stay within a few percent of raw Relic).

Ordering caveat: the pool preserves FIFO *per lane*, not globally — two
tasks striped onto different lanes may complete in either order. Callers
needing global FIFO use a single-lane runtime (``workers <= 1`` on the
scheduler SPI).
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Tuple

from repro_torch.core.relic import (_PROBE_EVERY_SPINS, Relic, RelicDeadError,
                              RelicStats, RelicUsageError, flatten_tasks)
from repro_torch.core.spsc import DEFAULT_CAPACITY
from repro_torch.runtime.config import resolve_supervise_config
from repro_torch.runtime.fault import LaneSupervisor

__all__ = ["LaneFailedError", "LaneFailure", "RelicPool", "RelicPoolStats"]


@dataclass(frozen=True)
class LaneFailure:
    """One quarantined lane: the deterministic accounting of a lane death.

    ``lost`` is exactly the dead ring's in-flight count (``submitted`` minus
    the final ``completed`` — final because the only writer of the
    completion counter is the dead thread), covering both the primary and
    the handoff ring. ``error`` carries the lane's pending first task error
    if one was recorded before death; ``respawned`` says whether a fresh
    lane took the slot (``RelicPool(respawn=True)``).
    """

    lane_index: int
    lane_name: str
    submitted: int
    completed: int
    lost: int
    error: Optional[BaseException]
    respawned: bool


class LaneFailedError(RelicDeadError):
    """One or more pool lanes died; surfaced deterministically at
    ``wait()`` (and by submit paths that can no longer make progress).

    Subclasses :class:`RelicDeadError` so ``except RelicDeadError`` covers
    both the pair and the pool; ``failures`` holds the per-lane
    :class:`LaneFailure` records, and the aggregate ``submitted`` /
    ``completed`` / ``lost`` fields sum them. ``first_task_error`` carries
    the window's earliest-submitted pending task error, if any — the lane
    failure outranks it on the error channel, but it stays observable.
    """

    def __init__(self, failures: Tuple[LaneFailure, ...],
                 first_task_error: Optional[BaseException] = None) -> None:
        self.failures = tuple(failures)
        self.lane = ", ".join(f.lane_name for f in self.failures)
        self.submitted = sum(f.submitted for f in self.failures)
        self.completed = sum(f.completed for f in self.failures)
        self.lost = sum(f.lost for f in self.failures)
        self.first_task_error = first_task_error
        detail = "; ".join(
            f"{f.lane_name}: lost={f.lost}"
            + (" (respawned)" if f.respawned else "")
            for f in self.failures)
        RuntimeError.__init__(
            self,
            f"pool lane(s) died [{detail}]: {self.lost} in-flight task(s) "
            "lost")


class RelicPoolStats:
    """Live aggregate view over the per-lane :class:`RelicStats`.

    Duck-compatible with ``SchedulerStats`` (``submitted``/``completed``/
    ``task_errors``/``last_error``) plus the Relic telemetry counters, all
    computed on read by summing the lanes — there is no second set of hot
    counters to keep coherent on the submit path. ``lanes`` exposes the
    underlying per-lane stats objects.
    """

    __slots__ = ("_pool",)

    def __init__(self, pool: "RelicPool"):
        self._pool = pool

    def _sum(self, attr: str) -> int:
        # _retired folds in the final counters of lanes replaced by a
        # respawn, keeping every aggregate monotonic across lane swaps.
        return (getattr(self._pool._retired, attr)
                + sum(getattr(lane.stats, attr)
                      for lane in self._pool._lanes))

    @property
    def submitted(self) -> int:
        return self._sum("submitted")

    @property
    def completed(self) -> int:
        return self._sum("completed")

    @property
    def task_errors(self) -> int:
        return self._sum("task_errors")

    @property
    def producer_full_spins(self) -> int:
        return self._sum("producer_full_spins")

    @property
    def assistant_empty_spins(self) -> int:
        return self._sum("assistant_empty_spins")

    @property
    def parks(self) -> int:
        return self._sum("parks")

    @property
    def last_error(self) -> Optional[BaseException]:
        """The stashed error (a ``close()``-time capture) if any, else the
        earliest-submitted pending lane error (the one ``wait()`` would
        raise). Observability only — reading it clears nothing."""
        if self._pool._stashed_error is not None:
            return self._pool._stashed_error
        best: Tuple[int, Optional[BaseException]] = (0, None)
        for i, lane in enumerate(self._pool._lanes):
            err = lane.stats.last_error
            if err is None:
                continue
            seq = self._pool._pending_error_seq(i, lane.stats)
            if best[1] is None or seq < best[0]:
                best = (seq, err)
        return best[1]

    @last_error.setter
    def last_error(self, value: Optional[BaseException]) -> None:
        # SchedulerStats duck-compat: the pool adapter stashes a close()-time
        # error here so it stays observable after shutdown.
        self._pool._stashed_error = value

    @property
    def lost_tasks(self) -> int:
        """Tasks deterministically written off to dead lanes (the sum of
        every :class:`LaneFailure`'s ``lost``)."""
        return self._pool._lost_tasks

    @property
    def lanes(self) -> Tuple[RelicStats, ...]:
        return tuple(lane.stats for lane in self._pool._lanes)

    def __repr__(self) -> str:
        return (f"RelicPoolStats(lanes={len(self._pool._lanes)}, "
                f"submitted={self.submitted}, completed={self.completed}, "
                f"task_errors={self.task_errors})")


class RelicPool:
    """N-lane Relic: one producer striping over N independent SPSC pairs.

    Usage mirrors :class:`Relic` exactly::

        pool = RelicPool(lanes=4)
        pool.start()
        pool.wake_up_hint()          # broadcast: a parallel section is imminent
        pool.submit(fn, a, b)        # main thread only; striped over the lanes
        ...                          # main thread does its own share
        pool.wait()                  # barrier across every lane
        pool.sleep_hint()            # broadcast park
        pool.shutdown()
    """

    def __init__(self, lanes: int = 2, capacity: int = DEFAULT_CAPACITY,
                 start_awake: bool = False, rebalance: bool = True,
                 respawn: bool = False, supervise: Optional[bool] = None,
                 heartbeat_ms: Optional[float] = None):
        if lanes <= 0:
            raise ValueError(f"lanes must be positive, got {lanes}")
        self._n = lanes
        self._capacity = capacity
        self._start_awake = start_awake
        # Graceful degradation (PR 8): a lane whose assistant thread died is
        # *quarantined* — removed from striping, its in-flight tasks
        # accounted as lost (see _quarantine_lane), the event surfaced at
        # the next wait() as LaneFailedError. With ``respawn=True`` a fresh
        # Relic takes the dead lane's slot so the pool keeps its width; the
        # pair's non-restartable contract is amended at *pool scope only* —
        # an individual Relic still never restarts, the pool replaces it.
        self._respawn = bool(respawn)
        # kwargs > RELIC_SUPERVISE / RELIC_HEARTBEAT_MS env > defaults.
        sup_cfg = resolve_supervise_config(supervise=supervise,
                                           heartbeat_ms=heartbeat_ms)
        self._supervise = sup_cfg.supervise
        self._heartbeat_s = sup_cfg.heartbeat_ms / 1000.0
        # Skew resistance (PR 6): with ``rebalance`` on, a burst remainder
        # stuck behind a wedged lane is re-dealt to lanes with room
        # (producer-side re-striping — see _rebalance_pending) and each
        # lane grows a victim-cooperative handoff ring its assistant
        # drains when idle. Off reproduces the PR 5 static striping
        # exactly. A single-lane pool has nowhere to re-deal to, so it
        # never pays for any of it (the degenerate pair path below).
        self._rebalance = bool(rebalance) and lanes > 1
        self._lanes = [
            Relic(capacity=capacity, start_awake=start_awake,
                  name=f"relic-pool-lane{i}", handoff=self._rebalance)
            for i in range(lanes)
        ]
        # The lanes' own bounded-wait probes follow the *pool's* resolved
        # supervision setting (a kwarg must be able to override the env the
        # lane constructors just read).
        for lane in self._lanes:
            lane._probe_every = _PROBE_EVERY_SPINS if self._supervise else 0
        self._rr = 0                 # round-robin cursor (next lane to try)
        self._seq = 0                # pool-global submission counter
        # Per-window submission log: _runs[i][k] is the global seq of lane
        # i's (base[i]+k)-th task. Appended by the producer per submission,
        # cleared at every wait() — it exists so first-error-wins can be
        # ordered by *submission order* across lanes, and it is the whole
        # per-task cost of pooling beyond the lane push itself. Between
        # waits it is kept bounded by trimming entries for already-
        # completed tasks (see _trim_runs), so a long-lived scope that
        # never barriers (pipeline-style fire-and-observe-by-handle use)
        # holds O(capacity) ints per lane, not one per task ever submitted.
        self._runs: List[List[int]] = [[] for _ in range(lanes)]
        self._base = [0] * lanes     # lane-local index of _runs[i][0]
        self._trim_at = 4 * capacity  # in-flight bound is 2*capacity, so at
        #                               this length at least half is trimmable
        # Handoff-ring twin of the seq log: _oruns[i][k] is the global seq
        # of the (obase[i]+k)-th task the producer pushed into lane i's
        # handoff ring. Same trim discipline, keyed off the lane's
        # handoff-completion counter — so first-error-wins ordering
        # survives re-striping (the seq rides whichever log matches the
        # ring that carried the task).
        self._oruns: List[List[int]] = [[] for _ in range(lanes)]
        self._obase = [0] * lanes
        self._stashed_error: Optional[BaseException] = None
        self._shutdown = False
        self._started = False
        self._main_ident: Optional[int] = None
        # Lane-supervision state: ``_live`` is the ordered list of lane
        # indexes still accepting submissions (striping runs over it, not
        # over range(n)); quarantine removes a slot, respawn re-adds it
        # with a fresh lane. ``_retired`` accumulates the final counters of
        # replaced lanes so the aggregate stats view stays monotonic across
        # a swap, and ``_lost_tasks`` is the cumulative deterministic
        # lost-task count (see LaneFailure).
        self._live: List[int] = list(range(lanes))
        self._failures: List[LaneFailure] = []
        self._failure_history: List[LaneFailure] = []  # never cleared
        self._lost_tasks = 0
        self._retired = RelicStats()
        self._gen = [0] * lanes      # respawn generation per slot (naming)
        self._supervisor = (
            LaneSupervisor(lanes, heartbeat_s=self._heartbeat_s)
            if self._supervise else None)
        # Hot-path pre-binds: one tuple load per submit instead of chasing
        # lane -> ring / lane -> stats chains per task. Rebuilt whenever
        # the live-lane set changes.
        self._hot: List[tuple] = []
        self._nl = lanes             # len(_live): the striping modulus
        self._rebuild_hot()
        if lanes == 1 and not self._respawn:
            # Degenerate pool == the pair, exactly: with one lane the
            # cursor never moves, every shard is the whole burst, and
            # cross-lane error ordering is the lane's own — so the
            # single-lane configuration pays for none of that bookkeeping
            # ("scaling must not tax the pair", measured by the scaling
            # benchmark's lanes1-vs-relic rows). With respawn on the slot
            # can be re-bound to a fresh lane, so the general striped path
            # (which reads ``_hot`` per call) is used instead.
            self._lane0 = self._lanes[0]
            self._push2_0 = self._lane0._push2
            self._stats0 = self._lane0.stats
            self._submit2 = self._submit2_single
        self.stats = RelicPoolStats(self)

    @property
    def n_lanes(self) -> int:
        return self._n

    # ------------------------------------------------------------------ roles

    def start(self) -> "RelicPool":
        if self._started:
            raise RelicUsageError("RelicPool already started")
        self._started = True
        self._main_ident = threading.get_ident()
        for lane in self._lanes:
            lane.start()
        return self

    def _check_main(self, what: str) -> None:
        ident = threading.get_ident()
        for lane in self._lanes:
            if lane._assistant is not None and ident == lane._assistant.ident:
                # Same rule as the pair (§VI-A): assistants cannot submit.
                raise RelicUsageError(f"{what} called from an assistant thread")
        if self._main_ident is not None and ident != self._main_ident:
            raise RelicUsageError(
                f"{what} must be called from the main (producer) thread")

    # ------------------------------------------------------------- public API

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        """Submit one task (main thread only), striped round-robin over the
        lanes with a least-loaded fallback. Busy-waits only when the
        fallback lane is full too (bounded backpressure)."""
        if threading.get_ident() != self._main_ident:
            self._check_main("submit()")   # slow path: classify the misuse
        if self._shutdown:
            raise RelicUsageError("submit() after shutdown")
        if kwargs:
            fn = functools.partial(fn, **kwargs)
        self._submit2(fn, args)

    def _submit2_single(self, fn: Callable[..., Any], args: tuple) -> None:
        """No-checks push for the lanes=1 degenerate pool (bound over
        ``_submit2`` at construction): the pair's own submit, nothing more.
        Accounts after the push like the pair (interrupt safety)."""
        if self._push2_0(fn, args):
            self._stats0.submitted += 1
            return
        self._lane0._push_spin(fn, args)
        self._stats0.submitted += 1

    def _submit2(self, fn: Callable[..., Any], args: tuple) -> None:
        """No-checks striped push (the scheduler adapter's fast path).
        Stripes over the *live* lanes (``_hot`` mirrors ``_live``)."""
        i = self._rr
        nxt = i + 1
        self._rr = nxt if nxt < self._nl else 0
        push2, lane_stats, runs, li = self._hot[i]
        if push2(fn, args):
            seq = self._seq
            self._seq = seq + 1
            lane_stats.submitted += 1
            runs.append(seq)
            if len(runs) >= self._trim_at:
                self._trim_runs(li)
            return
        self._submit_overflow(fn, args)

    def _submit2_dead(self, fn: Callable[..., Any], args: tuple) -> None:
        """Bound over ``_submit2`` once every lane is quarantined with
        respawn off: the pool can never run another task, so submitting
        raises instead of silently feeding a dead ring. (Pre-bound
        references — the scheduler adapter binds ``_submit2`` once — are
        covered by the sentinel hot entry ``_rebuild_hot`` installs, whose
        "push" raises the same way.)"""
        self._raise_pool_dead()

    def _submit_overflow(self, fn: Callable[..., Any], args: tuple) -> None:
        """Round-robin target full: try the other live lanes least-loaded
        first (by the ring's racy-but-monotonic ``len()`` — reading
        another lane's ring from here is the observer case its clamp
        exists for; a stale read costs balance, never correctness) and
        busy-wait *sweeping* until some lane accepts. Sweeping — rather
        than committing to one fallback lane — keeps the pool live when a
        lane is wedged behind a long task: backpressure engages only while
        every ring is full. With rebalancing on, "every ring" includes the
        handoff rings: a pool whose primaries are all backed up hands the
        task to the least-loaded lane's handoff ring (its assistant pulls
        from it when its primary goes idle) before resigning to the spin.

        The spin is *bounded* (PR 8): every ``_PROBE_EVERY_SPINS``
        no-progress rounds it sweeps lane liveness (``check_lanes``), so a
        pool spinning on rings whose assistants died quarantines them —
        respawn refills the slot with an empty ring the next round, and a
        fully-dead pool raises ``LaneFailedError`` instead of hanging."""
        lanes = self._lanes
        rebalance = self._rebalance
        supervise = self._supervise
        spins = 0
        pause_every = lanes[0]._spin_pause_every
        while True:
            live = self._live
            if not live:
                self._raise_pool_dead()
            order = sorted(live, key=lambda j: len(lanes[j]._ring))
            for j in order:
                lane = lanes[j]
                if lane._push2(fn, args):
                    seq = self._seq
                    self._seq = seq + 1
                    lane.stats.submitted += 1
                    runs = self._runs[j]
                    runs.append(seq)
                    if len(runs) >= self._trim_at:
                        self._trim_runs(j)
                    return
            if rebalance:
                for j in order:
                    lane = lanes[j]
                    if lane._oring.push2(fn, args):
                        seq = self._seq
                        self._seq = seq + 1
                        lane.stats.submitted += 1
                        oruns = self._oruns[j]
                        oruns.append(seq)
                        if len(oruns) >= self._trim_at:
                            self._trim_oruns(j)
                        return
            if spins == 0:
                # Advisory hints must not deadlock a full pool: un-park
                # every assistant once (only this blocked thread could
                # re-park them).
                for lane in lanes:
                    lane._awake.set()
            lanes[order[0]].stats.producer_full_spins += 1
            spins += 1
            if spins % pause_every == 0:
                time.sleep(0)
            if supervise and spins % _PROBE_EVERY_SPINS == 0:
                self.check_lanes()

    def submit_batch(
        self, tasks: Iterable[Tuple[Callable[..., Any], tuple, dict]]
    ) -> None:
        """Submit a burst of ``(fn, args, kwargs)`` tasks (main thread
        only), sharded across the lanes: the burst is flattened once into
        the ``fn, args`` stripe and split into contiguous near-equal
        shards dealt out from the round-robin cursor. Delivery is
        two-phase so a wedged lane cannot starve the others' shards: a
        first non-blocking pass hands every lane as much of its shard as
        its ring has room for (one ``push_many`` per lane), then the
        remainders are busy-wait *swept* round-robin under ring
        backpressure — every other lane's work is already flowing while
        the producer waits on a full one, and a cross-shard dependency
        (a lane-0 task blocking on a handle from lane 1's shard) can
        always make progress. With rebalancing on, a remainder the sweep
        cannot place at all is *re-striped* to lanes that do have room
        (see ``_rebalance_pending``) instead of waiting out its original
        lane.

        Accounting (``submitted``, the seq logs) is committed as each
        window is handed to a ring, never before: a ``BaseException``
        (KeyboardInterrupt) escaping the sweep therefore cannot strand
        ``submitted`` above what any assistant will ever pop — the
        pre-PR 6 failure mode where the next ``wait()`` busy-spun
        forever. The unaccounted residue of an interrupt is at most the
        tasks of one in-flight ``push_many`` window, which can only make
        a later barrier return *early*, never hang."""
        if threading.get_ident() != self._main_ident:
            self._check_main("submit_batch()")
        if self._shutdown:
            raise RelicUsageError("submit_batch() after shutdown")
        flat = flatten_tasks(tasks)
        k = len(flat) // 2
        if not k:
            return
        if self._n == 1 and not self._respawn:
            # Degenerate pool: the whole burst is lane 0's shard, and the
            # seq log is pointless with nothing to order across. (The
            # push raises RelicDeadError — bounded, never a hang — if the
            # assistant died mid-burst; with respawn off there is no slot
            # to rebuild, so it propagates as-is.)
            self._lanes[0]._push_flat(flat, account=True)
            return
        live = self._live
        n = len(live)
        if n == 0:
            self._raise_pool_dead()
        share, rem = divmod(k, n)
        seq0 = self._seq
        self._seq = seq0 + k
        cursor = self._rr
        if cursor >= n:
            cursor = 0
        pos = 0                       # task offset into the burst
        pending: List[list] = []      # [lane_idx, next_slot, stop_slot]
        for step in range(n):
            take = share + (1 if step < rem else 0)
            if take == 0:
                break                 # k < n: only the first k lanes get one
            s = cursor + step
            if s >= n:
                s -= n
            i = live[s]
            lane = self._lanes[i]
            start2, stop2 = 2 * pos, 2 * (pos + take)
            pushed = lane._ring.push_many(flat, start2, stop2)
            if pushed:
                self._account_window(i, lane, seq0 + pos, pushed // 2)
            if start2 + pushed < stop2:
                pending.append([i, start2 + pushed, stop2])
            pos += take
        # Advance the cursor by the burst remainder so the next burst's
        # +1 shards (and the next single submit) land on fresh lanes.
        self._rr = (cursor + rem) % n
        if pending:
            self._sweep_remainders(flat, pending, seq0)

    def _account_window(self, i: int, lane: Relic, seq_start: int,
                        p: int) -> None:
        """Record ``p`` tasks just pushed into lane ``i``'s *primary* ring,
        holding seqs ``seq_start..seq_start+p-1``. Called immediately after
        the push (never before — interrupt safety, see submit_batch)."""
        lane.stats.submitted += p
        runs = self._runs[i]
        runs.extend(range(seq_start, seq_start + p))
        if len(runs) >= self._trim_at:
            self._trim_runs(i)

    def _account_handoff_window(self, i: int, lane: Relic, seq_start: int,
                                p: int) -> None:
        """Same as ``_account_window`` for lane ``i``'s *handoff* ring."""
        lane.stats.submitted += p
        oruns = self._oruns[i]
        oruns.extend(range(seq_start, seq_start + p))
        if len(oruns) >= self._trim_at:
            self._trim_oruns(i)

    def _sweep_remainders(self, flat: list, pending: List[list],
                          seq0: int) -> None:
        """Phase 2 of a burst: drain shard remainders into their lanes,
        sweeping all of them each iteration (never committing to one full
        lane) and yielding under full-pool backpressure. Partial pushes
        are always pair-aligned: every publication is even-sized, so the
        free-slot count every ``push_many`` sees is even by induction.
        When a whole sweep makes no progress and rebalancing is on, the
        stuck remainders are re-striped to lanes with room before the
        producer resigns itself to spinning.

        Like ``_submit_overflow`` the spin is bounded (PR 8): a periodic
        liveness sweep quarantines dead lanes mid-burst. A respawned slot
        offers the remainder a fresh empty ring; with rebalancing on the
        remainder re-stripes to the survivors; with *both* off a dead
        slot's remainder can never drain, so the sweep raises
        ``LaneFailedError`` (the un-pushed remainder stays unaccounted —
        the same interrupt-safety contract as a KeyboardInterrupt here)."""
        lanes = self._lanes
        rebalance = self._rebalance
        supervise = self._supervise
        spins = 0
        pause_every = lanes[0]._spin_pause_every
        while pending:
            progressed = False
            for entry in list(pending):
                i, next2, stop2 = entry
                lane = lanes[i]
                pushed = lane._ring.push_many(flat, next2, stop2)
                if pushed:
                    progressed = True
                    self._account_window(i, lane, seq0 + next2 // 2,
                                         pushed // 2)
                    next2 += pushed
                    if next2 >= stop2:
                        pending.remove(entry)
                    else:
                        entry[1] = next2
            if not pending:
                return
            if not progressed:
                if rebalance and self._rebalance_pending(flat, pending, seq0):
                    continue
                if spins == 0:
                    # Advisory hints must not deadlock a burst: a parked
                    # assistant is a stalled lane's only possible drain.
                    for i, _, _ in pending:
                        lanes[i]._awake.set()
                lanes[pending[0][0]].stats.producer_full_spins += 1
                spins += 1
                if spins % pause_every == 0:
                    time.sleep(0)
                if supervise and spins % _PROBE_EVERY_SPINS == 0 \
                        and self.check_lanes():
                    if not self._respawn and not rebalance and any(
                            e[0] not in self._live for e in pending):
                        raise LaneFailedError(tuple(self._failures))

    def _rebalance_pending(self, flat: list, pending: List[list],
                           seq0: int) -> bool:
        """Re-stripe stuck remainders (producer-side dynamic load
        balancing). For each remainder whose own lane has no room, move a
        head window to another lane: first into primary rings with free
        slots, then — when every primary is full — into handoff rings.
        Returns True when any task moved (the sweep then retries instead
        of spinning).

        Every push here remains strictly single-producer (this thread is
        the only pusher of every primary *and* handoff ring) and sized by
        ``SpscRing.free_slots()``, a producer-side lower bound — so a
        window never partially pushes and accounting can follow each push
        exactly. Lanes that themselves have a stuck remainder are skipped
        as destinations: their rings are full by definition, and skipping
        them keeps this pass O(lanes) per remainder."""
        lanes = self._lanes
        stuck = {entry[0] for entry in pending}
        order = sorted((j for j in self._live if j not in stuck),
                       key=lambda j: len(lanes[j]._ring))
        moved = False
        for entry in list(pending):
            i, next2, stop2 = entry
            for j in order:
                want = (stop2 - next2) // 2
                if want <= 0:
                    break
                lane = lanes[j]
                room = lane._ring.free_slots() // 2
                if room > 0:
                    m = min(want, room)
                    pushed = lane._ring.push_many(flat, next2, next2 + 2 * m)
                    self._account_window(j, lane, seq0 + next2 // 2,
                                         pushed // 2)
                    next2 += pushed
                    entry[1] = next2
                    moved = True
                    continue
                oring = lane._oring
                if oring is None:
                    continue
                room = oring.free_slots() // 2
                if room <= 0:
                    continue
                m = min(want, room)
                pushed = oring.push_many(flat, next2, next2 + 2 * m)
                self._account_handoff_window(j, lane, seq0 + next2 // 2,
                                             pushed // 2)
                next2 += pushed
                entry[1] = next2
                moved = True
            if next2 >= stop2:
                pending.remove(entry)
        return moved

    def wait(self) -> None:
        """Barrier across every lane; first-error-wins by submission order.

        Each lane is barriered (its spin loop, no raise), its pending
        first error — if any — is mapped to the pool-global submission
        seq *while the error state is still set* (the seq logs need the
        index fields), and only then consumed via ``_take_error`` (which
        clears the error and its index fields as one unit — the PR 6
        stale-index bugfix). The earliest-submitted error re-raises; all
        other errors from this window are dropped from the error channel
        (they remain counted in ``stats.task_errors``) — the same
        later-failures-only-bump rule the pair applies within one lane.

        Lane deaths outrank task errors (PR 8): a barrier that finds a
        dead assistant (its bounded-wait probe raises ``RelicDeadError``)
        quarantines the lane — respawning into the slot when enabled —
        and ``wait()`` raises :class:`LaneFailedError` carrying every
        queued :class:`LaneFailure` (including ones detected earlier by
        ``check_lanes`` or a submit path). The window's earliest pending
        *task* error, if any, rides along as ``first_task_error``."""
        self._check_main("wait()")
        errors: List[Tuple[int, BaseException]] = []
        for i in range(self._n):
            if i not in self._live:
                continue    # quarantined: frozen, nothing will ever drain it
            lane = self._lanes[i]
            try:
                lane._barrier()
            except RelicDeadError:
                self._quarantine_lane(i, lane)
                continue
            if lane.stats.last_error is not None:
                seq = self._pending_error_seq(i, lane.stats)
                err = lane._take_error()
                if err is not None:
                    errors.append((seq, err))
        for i in range(self._n):
            # base + len(runs) == tasks ever pushed to that ring: the next
            # window's local indexes continue from there. (Not the lane's
            # ``submitted`` — with rebalancing that counter spans both
            # rings, while each log is per-ring.)
            self._base[i] += len(self._runs[i])
            self._runs[i].clear()
            self._obase[i] += len(self._oruns[i])
            self._oruns[i].clear()
        errors.sort(key=lambda pair: pair[0])
        if self._failures:
            failures = tuple(self._failures)
            self._failures.clear()
            raise LaneFailedError(
                failures,
                first_task_error=errors[0][1] if errors else None)
        if not self._live:
            # Permanently dead pool (every lane quarantined, respawn off):
            # each wait() keeps raising — a silent return here would let
            # post-death submissions into dead rings pass as "completed".
            raise LaneFailedError(
                tuple(self._failure_history),
                first_task_error=errors[0][1] if errors else None)
        if errors:
            raise errors[0][1]

    # ------------------------------------------------- lane supervision (PR 8)

    def _rebuild_hot(self) -> None:
        """Regenerate the submit pre-binds from the live-lane set (called
        at construction and after every quarantine/respawn)."""
        self._hot = [
            (self._lanes[i]._push2, self._lanes[i].stats, self._runs[i], i)
            for i in self._live
        ]
        self._nl = len(self._hot)
        if self._rr >= self._nl:
            self._rr = 0
        if self._nl == 0:
            # Every lane dead, respawn off: fail fast on the submit path.
            # The sentinel hot entry keeps *pre-bound* callers (the
            # scheduler adapter binds the class ``_submit2`` once) raising
            # too: its "push" is the raise itself.
            self._submit2 = self._submit2_dead
            self._hot = [(self._raise_pool_dead_push, None, [], -1)]
            self._nl = 1

    def _raise_pool_dead_push(self, fn: Callable[..., Any],
                              args: tuple) -> bool:
        self._raise_pool_dead()
        return False               # pragma: no cover - unreachable

    def _raise_pool_dead(self) -> None:
        raise LaneFailedError(tuple(self._failures or self._failure_history))

    def _quarantine_lane(self, li: int, dead: Relic) -> LaneFailure:
        """Remove a dead lane from striping (pool-owner thread only),
        account its in-flight tasks as lost, and — with ``respawn=True`` —
        put a fresh lane in the slot.

        The lost count is final arithmetic, not an estimate: the
        completion counter's only writer is the dead thread, so
        ``submitted - completed`` is exactly the tasks stranded across the
        lane's primary and handoff rings. SPSC invariants survive by
        construction — nothing ever pops a quarantined ring again (its
        single consumer is the dead thread), and a respawned slot gets a
        brand-new :class:`Relic` with fresh rings, so every ring keeps
        exactly one producer and one consumer for its whole lifetime."""
        self._live.remove(li)
        submitted = dead.stats.submitted
        completed = dead._completed
        dead.stats.completed = completed  # final snapshot for the stats view
        lost = submitted - completed
        self._lost_tasks += lost
        failure = LaneFailure(
            lane_index=li, lane_name=dead._name, submitted=submitted,
            completed=completed, lost=lost, error=dead.stats.last_error,
            respawned=self._respawn)
        self._failures.append(failure)
        self._failure_history.append(failure)
        if self._respawn:
            # Retire the dead lane's final counters into the aggregate so
            # the pool stats stay monotonic across the swap, then rebuild
            # the slot: fresh Relic (fresh rings), reset seq logs, reset
            # the supervisor's memory of the slot.
            r, s = self._retired, dead.stats
            r.submitted += submitted
            r.completed += completed
            r.task_errors += s.task_errors
            r.producer_full_spins += s.producer_full_spins
            r.assistant_empty_spins += s.assistant_empty_spins
            r.parks += s.parks
            self._gen[li] += 1
            fresh = Relic(capacity=self._capacity,
                          start_awake=self._start_awake,
                          name=f"relic-pool-lane{li}-r{self._gen[li]}",
                          handoff=self._rebalance)
            fresh._probe_every = (_PROBE_EVERY_SPINS if self._supervise
                                  else 0)
            self._lanes[li] = fresh
            self._runs[li] = []
            self._base[li] = 0
            self._oruns[li] = []
            self._obase[li] = 0
            if self._supervisor is not None:
                self._supervisor.reset_lane(li)
            if self._started:
                fresh.start()
            self._live.append(li)
            self._live.sort()
        self._rebuild_hot()
        return failure

    def check_lanes(self) -> List[LaneFailure]:
        """Supervision sweep (pool-owner thread only): quarantine lanes
        whose assistant thread died — respawning when enabled — and feed
        the :class:`LaneSupervisor` one progress-heartbeat sample. Cheap
        to call often (the supervisor samples once per heartbeat period).
        Returns the *new* failures; they also stay queued for the next
        ``wait()`` unless drained with ``take_lane_failures``."""
        if not self._supervise:
            return []
        new: List[LaneFailure] = []
        for li in list(self._live):
            lane = self._lanes[li]
            if not lane.is_alive():
                new.append(self._quarantine_lane(li, lane))
        sup = self._supervisor
        if sup is not None:
            completed: List[int] = []
            outstanding: List[int] = []
            for li, lane in enumerate(self._lanes):
                done = lane._completed
                completed.append(done)
                # A quarantined slot reads as idle, not stalled: nothing
                # is outstanding that supervision could still save.
                outstanding.append(
                    (lane.stats.submitted - done) if li in self._live else 0)
            sup.observe(completed, outstanding)
        return new

    def take_lane_failures(self) -> Tuple[LaneFailure, ...]:
        """Drain the queued quarantine records without a barrier
        (pool-owner thread only) — the serve loop's fire-and-observe
        supervision read. Once drained, ``wait()`` no longer raises for
        these failures."""
        if not self._failures:
            return ()
        out = tuple(self._failures)
        self._failures.clear()
        return out

    def in_flight_estimate(self) -> int:
        """Racy-but-monotone estimate of tasks admitted to live rings and
        not yet executed: total submitted minus total completed minus the
        tasks written off as lost. Reads each lane's live completion
        counter directly (the per-lane ``stats.completed`` snapshot only
        refreshes at barriers, which a serving loop never runs). Reaches
        exactly 0 once the live lanes drain — the serve layer's quiesce
        predicate after a lane death."""
        submitted = self._retired.submitted
        completed = self._retired.completed
        for lane in self._lanes:
            submitted += lane.stats.submitted
            completed += lane._completed
        est = submitted - completed - self._lost_tasks
        return est if est > 0 else 0

    def stalled_lanes(self) -> List[int]:
        """Advisory: slots with outstanding work and no completion
        progress for ~2 heartbeat periods (see ``LaneSupervisor``)."""
        return [] if self._supervisor is None else self._supervisor.stalled()

    def straggler_lanes(self) -> List[int]:
        """Advisory: slots persistently slower than their peers."""
        return ([] if self._supervisor is None
                else self._supervisor.stragglers())

    @property
    def live_lanes(self) -> Tuple[int, ...]:
        return tuple(self._live)

    @property
    def lost_tasks(self) -> int:
        return self._lost_tasks

    def _trim_runs(self, lane_idx: int) -> None:
        """Drop seq-log entries for tasks the lane has already completed,
        keeping a pending first error's entry mappable. Called from the
        submit paths when a lane's log reaches ``_trim_at`` (amortized
        O(1) per task): between barriers the log then stays O(capacity) —
        the in-flight bound — instead of one entry per task ever
        submitted, so fire-and-observe-by-handle consumers that never
        call ``wait()`` cannot grow it without bound. The completion
        estimate is a racy cross-thread read, but it only ever
        undercounts (``_completed_main_estimate``): trimming too little
        is safe, and an error recorded at-or-after it is by construction
        still in the log."""
        lane = self._lanes[lane_idx]
        base = self._base[lane_idx]
        keep_from = lane._completed_main_estimate()
        if lane.stats.last_error is not None:
            fei = lane.stats.first_error_index
            if fei is not None and fei < keep_from:
                keep_from = fei        # the pending error must stay mappable
        drop = keep_from - base
        if drop > 0:
            del self._runs[lane_idx][:drop]
            self._base[lane_idx] = base + drop

    def _trim_oruns(self, lane_idx: int) -> None:
        """Handoff-ring twin of ``_trim_runs``: keyed off the lane's
        handoff-completion counter (monotonic; a stale read undercounts,
        so over-retention is the only failure mode) and the pending
        error's handoff index when it rode this ring."""
        lane = self._lanes[lane_idx]
        base = self._obase[lane_idx]
        keep_from = lane._completed_ovf
        if lane.stats.last_error is not None:
            fei = lane.stats.first_error_handoff_index
            if fei is not None and fei < keep_from:
                keep_from = fei
        drop = keep_from - base
        if drop > 0:
            del self._oruns[lane_idx][:drop]
            self._obase[lane_idx] = base + drop

    def _seq_of(self, lane_idx: int, local_idx: Optional[int]) -> int:
        """Pool-global submission seq of lane ``lane_idx``'s ``local_idx``-th
        *primary-ring* task (this window). Out-of-window indexes
        (defensive: should not happen — errors are cleared per window)
        order last."""
        if local_idx is None:
            return self._seq
        off = local_idx - self._base[lane_idx]
        runs = self._runs[lane_idx]
        if 0 <= off < len(runs):
            try:
                return runs[off]
            except IndexError:
                # Racy observer (the stats view's last_error getter runs on
                # any thread): the producer's wait() may clear the window
                # log between the bounds check and the index. Fall through.
                pass
        return self._seq

    def _oseq_of(self, lane_idx: int, local_idx: Optional[int]) -> int:
        """``_seq_of`` for the lane's *handoff* ring (its own log/base)."""
        if local_idx is None:
            return self._seq
        off = local_idx - self._obase[lane_idx]
        oruns = self._oruns[lane_idx]
        if 0 <= off < len(oruns):
            try:
                return oruns[off]
            except IndexError:
                pass                   # racy observer, as in _seq_of
        return self._seq

    def _pending_error_seq(self, lane_idx: int, stats: RelicStats) -> int:
        """Submission seq of a lane's pending first error, whichever ring
        carried the failed task (exactly one index field is set while
        ``last_error`` is pending)."""
        hidx = stats.first_error_handoff_index
        if hidx is not None:
            return self._oseq_of(lane_idx, hidx)
        return self._seq_of(lane_idx, stats.first_error_index)

    # ------------------------------------------------------- hints (broadcast)

    def wake_up_hint(self) -> None:
        """Broadcast §VI-B wake hint: unpark every lane's assistant."""
        for lane in self._lanes:
            lane.wake_up_hint()

    def sleep_hint(self) -> None:
        """Broadcast §VI-B sleep hint: every lane's assistant may park."""
        for lane in self._lanes:
            lane.sleep_hint()

    # -------------------------------------------------------------- lifecycle

    def shutdown(self, timeout: float = 5.0) -> None:
        """Shut down every lane. If any lane's assistant is wedged past its
        join timeout the pool (like the pair) becomes non-restartable: the
        first such error re-raises after *all* lanes were attempted."""
        self._shutdown = True
        first_err: Optional[RelicUsageError] = None
        for lane in self._lanes:
            try:
                lane.shutdown(timeout)
            except RelicUsageError as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def __enter__(self) -> "RelicPool":
        return self.start()

    def __exit__(self, exc_type: Any, *exc: Any) -> None:
        try:
            self.shutdown()
        except RelicUsageError:
            if exc_type is None:
                raise
