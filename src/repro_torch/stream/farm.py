"""Task farm: FastFlow's emitter → N workers → collector over SPSC rings.

A farm parallelizes ONE stage across N worker assistants while keeping
every ring 1P1C (Aldinucci et al., 2009 — no MPMC queue appears even
though N workers share the load):

* the **emitter** assistant is the sole consumer of the farm's input ring
  and the sole producer of each worker's private input ring (N rings, one
  producer each);
* each **worker** assistant (a plain :class:`Stage` wrapping the farm fn)
  is the sole consumer of its input ring and sole producer of its output
  ring;
* the **collector** assistant is the sole consumer of every worker output
  ring and the sole producer of the farm's output ring.

The emitter deals round-robin with a skip-if-full scan (a full — i.e.
slow — worker loses its turn instead of stalling the whole farm; the
bounded wait only engages when *every* worker ring is full). The emitter
tags each item with a sequence number; with ``ordered=True`` (default)
the collector releases results in exactly input order using the same
index-stash pattern ``PrefetchPipeline`` used for its in-order window —
out-of-order results park in a dict keyed by sequence until their turn.
``ordered=False`` releases in completion order (lower latency, no stash).

Failure semantics are fail-stop per assistant, like Relic: an item whose
fn raised becomes an in-stream :class:`StreamFailure` (the farm keeps
going), but a *dead worker assistant* (non-``Exception`` escape, killed
thread) takes its in-flight items with it. The farm accounts for that
loss **exactly**: the emitter keeps a per-worker dealt ledger (appended
before every push, retired by the collector on every release), so when
the collector's bounded wait detects a dead worker the lost in-flight
tags are precisely dealt-minus-released. What happens next is the PR 8
quarantine/respawn discipline lifted up a stratum:

* ``respawn=False`` (default): the collector quarantines the slot and
  raises :class:`StageFailedError` carrying the lost tag set — callers
  know exactly which items to re-submit instead of guessing from a count.
* ``respawn=True``: the collector quarantines the slot (the emitter stops
  dealing to the dead ring), swaps in a **fresh** worker stage with fresh
  rings (every ring keeps exactly one producer and one consumer for its
  whole lifetime), and hands the lost ``(tag, item)`` pairs back to the
  emitter over a dedicated 1P1C redeal ring for idempotent re-emit under
  their *original* sequence tags. The collector dedups releases by tag,
  so replay is exactly-once even if a copy ever raced through. A worker
  that dies after end-of-stream (its STOP already dealt or the emitter
  already draining) is recovered *inline* at the collector — same tags,
  same exactly-once ledger, no emitter involvement needed.

A ``Farm`` presents the same node interface as :class:`Stage`, so it
drops into a :class:`repro_torch.stream.Pipeline` anywhere a stage fits
(``Pipeline([pre, Farm(heavy, workers=4), post])``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.core.relic import RelicDeadError
from repro_torch.core.spsc import DEFAULT_CAPACITY, SpscRing
from repro_torch.stream.stage import (STOP, Stage, StageFailedError, StreamFailure,
                                StreamUsageError, _always_alive)

__all__ = ["Farm", "WorkerFailure"]


@dataclass(frozen=True)
class WorkerFailure:
    """One dead farm worker, fully accounted (the stream-layer analogue of
    ``repro_torch.core.relic_pool.LaneFailure``): which slot died, exactly which
    sequence tags were in flight with it (dealt-minus-released), the fatal
    error, and how the farm recovered — ``respawned`` (fresh worker in the
    slot), ``reemitted`` (tags replayed through the emitter; ``False``
    with ``respawned`` unset means they were replayed inline at the
    collector after end-of-stream). ``detected_s``/``recovered_s`` are
    ``perf_counter`` stamps for detection/recovery latency measurement."""

    worker_index: int
    worker_name: str
    lost_tags: Tuple[int, ...]
    error: Optional[BaseException]
    respawned: bool
    reemitted: bool
    detected_s: float
    recovered_s: float


class _Emitter(Stage):
    """Deals tagged items round-robin into the worker input rings."""

    def __init__(self, farm: "Farm", **kwargs: Any):
        super().__init__(None, name=f"{farm.name}-emit", **kwargs)
        self._farm = farm
        #: Deal-progress epoch: bumped (single writer — this loop) before
        #: every quarantine-flag check and on every idle/wait spin. The
        #: collector's quarantine handshake waits for one tick: because
        #: the emitter is one thread, an observed advance proves any deal
        #: that predates the flag has completed its ledger append, and
        #: every later deal sees the flag.
        self._epoch = 0
        #: False once the emitter has popped STOP: quarantine recovery
        #: from then on happens inline at the collector (the workers are
        #: about to receive their STOPs; nothing can be re-emitted).
        self._accepting = True

    def _run_loop(self) -> None:
        farm = self._farm
        pop = self._in.pop
        redeal = farm._redeal
        pause_every = self._pause_every
        probe_every = self._probe_every
        rr = 0
        seq = 0
        spins = 0
        while True:
            rd = redeal.pop()
            if rd is not None:
                # A lost tag handed back by the collector after a worker
                # death: re-emit under its original sequence tag.
                rr = self._deal(rd, rr)
                self.items_out += 1
                spins = 0
                continue
            item = pop()
            if item is None:
                self._epoch += 1
                spins += 1
                if self._parked:
                    time.sleep(200e-6)    # parked idle (see Stage.sleep_hint)
                elif spins % pause_every == 0:
                    time.sleep(0)
                if not (probe_every and spins % probe_every == 0):
                    continue
                if self._upstream_alive():
                    continue
                item = pop()
                if item is None:
                    raise self._dead_upstream()
            spins = 0
            if item is STOP:
                self._shutdown()
                return
            self.items_in += 1
            rr = self._deal((seq, item), rr)
            seq += 1
            self.items_out += 1

    def _deal(self, payload: tuple, rr: int) -> int:
        """Skip-if-full deal into the first unquarantined worker ring
        starting at ``rr``; returns the next round-robin start. The
        speculative dealt-ledger append *precedes* the push, so a tag can
        never sit in a ring without being in the ledger (the collector's
        dealt-minus-released loss accounting depends on it); a failed
        push retracts the append (this loop is the deque's only
        right-end writer, the collector only ever pops the left)."""
        farm = self._farm
        n = len(farm._workers)
        pause_every = self._pause_every
        probe_every = self._probe_every
        wait_spins = 0
        while True:
            for k in range(n):
                i = (rr + k) % n
                self._epoch += 1
                if farm._quarantined[i]:
                    continue
                d = farm._dealt[i]
                d.append(payload)
                if farm._worker_in[i].push(payload):
                    return i + 1
                d.pop()
            wait_spins += 1
            if wait_spins % pause_every == 0:
                time.sleep(0)
            if probe_every and wait_spins % probe_every == 0:
                if not any(w.alive() for w in farm._workers) and not (
                        farm._respawn and self._accepting
                        and farm._collector.alive()):
                    raise RelicDeadError(
                        f"farm {farm.name!r}: every worker is dead",
                        self.items_in, self.items_out,
                        max(self.items_in - self.items_out, 0))

    def _shutdown(self) -> None:
        """End-of-stream: stop accepting re-emits, let an in-progress
        collector quarantine cycle finish (it reads ``_accepting`` under
        the farm's ``_claiming`` flag — after this wait any new cycle
        recovers inline instead), service the final re-emits, then
        broadcast STOP to every worker."""
        farm = self._farm
        self._accepting = False
        rr = 0
        spins = 0
        while farm._claiming and farm._collector.alive():
            self._epoch += 1
            rd = farm._redeal.pop()
            if rd is not None:
                rr = self._deal(rd, rr)
                self.items_out += 1
                continue
            spins += 1
            if spins % self._pause_every == 0:
                time.sleep(0)
        while True:
            rd = farm._redeal.pop()
            if rd is None:
                break
            rr = self._deal(rd, rr)
            self.items_out += 1
        for i in range(len(farm._workers)):
            self._broadcast_stop(i)

    def _broadcast_stop(self, i: int) -> None:
        farm = self._farm
        spins = 0
        while True:
            self._epoch += 1
            if (not farm._quarantined[i]
                    and farm._worker_in[i].push(STOP)):
                return
            spins += 1
            if spins % self._pause_every == 0:
                time.sleep(0)
            if (self._probe_every and spins % self._probe_every == 0
                    and not farm._workers[i].alive()):
                # Dead worker: the collector's probe accounts it (a
                # quarantined dead slot at this point is terminally
                # closed — post-STOP recovery is inline). A quarantined
                # *live* slot is a respawn completing; keep waiting for
                # the fresh ring.
                return


class _Collector(Stage):
    """Merges worker outputs: ordered release, exact loss accounting on a
    dead worker, quarantine + re-emit/inline recovery."""

    def __init__(self, farm: "Farm", **kwargs: Any):
        super().__init__(None, name=f"{farm.name}-collect", **kwargs)
        self._farm = farm

    def _run_loop(self) -> None:
        farm = self._farm
        workers = farm._workers
        outs = [w.out_ring for w in workers]
        n = len(outs)
        ordered = farm.ordered
        respawn = farm._respawn
        probe_every = self._probe_every
        pause_every = self._pause_every
        stops = [False] * n
        remaining = n
        stash: dict = {}
        next_rel = 0
        # Unordered dedup state (ordered mode dedups against
        # next_rel/stash directly): released-tag set compacted to a
        # contiguous watermark, bounded by the out-of-order window.
        released: set = set()
        rel_mark = -1
        spins = 0

        def release(item: Any) -> None:
            """Release one tagged result downstream, exactly once: a tag
            at or behind the release frontier is a replayed duplicate and
            is dropped (counted in ``farm.dup_dropped``)."""
            nonlocal next_rel, rel_mark
            seq, payload = item
            if ordered:
                if seq < next_rel or seq in stash:
                    farm.dup_dropped += 1
                    return
                self.items_in += 1
                stash[seq] = payload
                while next_rel in stash:
                    self._push_out(stash.pop(next_rel))
                    next_rel += 1
                    self.items_out += 1
            else:
                if respawn:
                    if seq <= rel_mark or seq in released:
                        farm.dup_dropped += 1
                        return
                    released.add(seq)
                    while rel_mark + 1 in released:
                        released.discard(rel_mark + 1)
                        rel_mark += 1
                self.items_in += 1
                self._push_out(payload)
                self.items_out += 1

        def take(i: int) -> Any:
            """Pop one item from worker ``i``, retiring its tag from the
            dealt ledger — the release half of dealt-minus-released."""
            item = outs[i].pop()
            if item is not None and item is not STOP:
                dealt = farm._dealt[i]
                if not dealt or dealt[0][0] != item[0]:
                    raise StageFailedError(
                        f"farm {farm.name!r}: dealt-ledger desync at "
                        f"worker {workers[i].name!r}",
                        self.items_in, self.items_out, (item[0],),
                        stage=workers[i].name)
                dealt.popleft()
            return item

        def pump() -> bool:
            """One merge sweep: at most one item per live worker."""
            nonlocal remaining
            progress = False
            for j in range(n):
                if stops[j]:
                    continue
                item = take(j)
                if item is None:
                    continue
                progress = True
                if item is STOP:
                    stops[j] = True
                    remaining -= 1
                else:
                    release(item)
            return progress

        def replay_inline(pairs: List[tuple]) -> None:
            """Recover lost tags on this thread (end-of-stream route):
            apply the farm fn and release under the same dedup ledger."""
            for pair in pairs:
                release(farm._work(pair))
                farm.reemitted_tags.append(pair[0])

        def push_redeal(pairs: List[tuple]) -> None:
            """Hand lost (tag, item) pairs back to the emitter (sole
            consumer of the redeal ring) for idempotent re-emit; keeps
            the merge pumping so a full network cannot deadlock the
            handover."""
            for pair in pairs:
                while not farm._redeal.push(pair):
                    if not pump():
                        time.sleep(0)
                    if not farm._emitter.alive():
                        raise StageFailedError(
                            f"farm {farm.name!r}: emitter died during "
                            "re-emit", self.items_in, self.items_out,
                            [p[0] for p in pairs],
                            stage=farm._emitter.name)
                farm.reemitted_tags.append(pair[0])

        def recover(i: int) -> bool:
            """Quarantine dead worker ``i`` and recover its in-flight
            tags, computed EXACTLY as dealt-minus-released. Returns True
            when the slot is terminally closed (counts as its STOP)."""
            emitter = farm._emitter
            t_detect = time.perf_counter()
            # 1. Freeze the deal flow into the slot, then wait one deal
            #    epoch: the emitter is a single thread that bumps the
            #    epoch before every quarantine check, so an observed
            #    advance proves the ledger below is final (any deal in
            #    flight at flag-set time appended its tag first; every
            #    later deal skips the slot).
            farm._quarantined[i] = True
            e0 = emitter._epoch
            hs = 0
            while emitter._epoch == e0 and emitter.alive():
                hs += 1
                if hs % pause_every == 0:
                    time.sleep(0)
            # 2. Adopt the abandoned input ring (its consumer is dead,
            #    its producer now skips it — 1P1C survives by the same
            #    argument as RelicPool's quarantine) and drain it: the
            #    items are replayed from the dealt ledger, but a STOP in
            #    there means this slot's stream already ended.
            stop_raced = False
            old_in = farm._worker_in[i]
            while True:
                it = old_in.pop()
                if it is None:
                    break
                if it is STOP:
                    stop_raced = True
            # 3. Snapshot the loss. take(i) already drained the final
            #    publications (a dead worker publishes nothing more), so
            #    the ledger remainder is exactly dealt-minus-released.
            lost = list(farm._dealt[i])
            lost_tags = tuple(p[0] for p in lost)
            error = workers[i].error()

            def record(respawned: bool, reemitted: bool) -> None:
                farm._failures.append(WorkerFailure(
                    worker_index=i, worker_name=workers[i].name,
                    lost_tags=lost_tags, error=error,
                    respawned=respawned, reemitted=reemitted,
                    detected_s=t_detect,
                    recovered_s=time.perf_counter()))

            if stop_raced:
                # The emitter already ended this slot's stream; recover
                # inline and close the slot (its STOP died with it).
                replay_inline(lost)
                record(respawned=False, reemitted=False)
                return True
            if not respawn:
                record(respawned=False, reemitted=False)
                raise StageFailedError(
                    f"farm {farm.name!r} worker {workers[i].name!r}",
                    self.items_in, self.items_out, lost_tags,
                    stage=workers[i].name)
            # Decide re-emit vs inline under the claiming flag: the
            # emitter's own STOP path waits for an in-progress claim
            # (draining re-emits meanwhile), which makes this read of
            # ``_accepting`` race-free — see _Emitter._shutdown.
            farm._claiming = True
            try:
                if emitter._accepting and emitter.alive():
                    self._respawn_slot(i, outs)
                    push_redeal(lost)
                    record(respawned=True, reemitted=True)
                    return False
                if not emitter._accepting:
                    # Stream ended normally while the worker died:
                    # recover inline, close the slot.
                    replay_inline(lost)
                    record(respawned=False, reemitted=False)
                    return True
                # Emitter died abnormally: items still in the farm input
                # are unreachable; recovery cannot preserve the stream.
                record(respawned=False, reemitted=False)
                raise StageFailedError(
                    f"farm {farm.name!r} worker {workers[i].name!r} "
                    "(emitter dead, stream unrecoverable)",
                    self.items_in, self.items_out, lost_tags,
                    stage=workers[i].name)
            finally:
                farm._claiming = False

        while remaining:
            if pump():
                spins = 0
                continue
            spins += 1
            if self._parked:
                time.sleep(200e-6)        # parked idle (see Stage.sleep_hint)
            elif spins % pause_every == 0:
                time.sleep(0)
            if not (probe_every and spins % probe_every == 0):
                continue
            for i in range(n):
                if stops[i] or workers[i].alive():
                    continue
                item = take(i)   # racing final publication
                if item is STOP:
                    stops[i] = True
                    remaining -= 1
                elif item is not None:
                    release(item)
                else:
                    if recover(i):
                        stops[i] = True
                        remaining -= 1
                    spins = 0
        if stash:
            # Sequence gaps with no dead worker left to blame: the tags
            # never released. Fail loudly — and say which — over silently
            # reordering.
            missing = tuple(s for s in range(next_rel, max(stash) + 1)
                            if s not in stash)
            raise StageFailedError(
                f"farm {farm.name!r}: {len(missing)} items lost in-flight",
                self.items_in, self.items_out, missing)
        self._push_out(STOP)

    def _respawn_slot(self, i: int, outs: List[SpscRing]) -> None:
        """Put a fresh worker in slot ``i`` (collector thread only):
        brand-new Stage, brand-new rings — so every ring keeps exactly
        one producer and one consumer for its whole lifetime — then
        reopen the slot to the emitter."""
        farm = self._farm
        farm._gen[i] += 1
        fresh = Stage(farm._work, name=f"{farm.name}-w{i}r{farm._gen[i]}",
                      capacity=farm.capacity, substrate=farm._substrate,
                      record=farm.record)
        fresh_ring = SpscRing(farm.capacity)
        fresh.connect(fresh_ring, farm._emitter.alive)
        fresh.set_downstream_alive(self.alive)
        farm._retired.append(farm._workers[i])
        farm._dealt[i] = deque()
        farm._worker_in[i] = fresh_ring
        farm._workers[i] = fresh        # same list object the emitter scans
        outs[i] = fresh.out_ring
        fresh.start()
        farm._quarantined[i] = False


class Farm:
    """Emitter → ``workers`` parallel stages → collector, as one node.

    ``fn`` is applied to each item by whichever worker the emitter dealt
    it to; ``ordered`` controls collector release order (input order vs
    completion order). ``substrate`` must be a registry *name* — a farm
    hosts ``workers + 2`` loops, so each gets its own instance; a single
    ``Scheduler`` instance cannot be shared (wrap the fn in a plain
    ``Stage`` for that). With a ``workers=0`` substrate the enclosing
    Pipeline runs the farm inline (``fn`` applied directly).

    ``respawn=True`` opts into dead-worker replacement: a worker whose
    assistant dies is quarantined, a fresh stage takes its slot, and its
    lost in-flight tags are re-emitted exactly once (see the module
    docstring for the recovery protocol). The default is fail-stop with
    exact accounting: a :class:`StageFailedError` carrying the lost tag
    set, so callers can re-submit precisely the lost work.
    """

    def __init__(self, fn: Callable[[Any], Any], *, workers: int = 2,
                 name: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 substrate: str = "relic", ordered: bool = True,
                 respawn: bool = False, record: bool = False):
        if not isinstance(substrate, str):
            raise StreamUsageError(
                "Farm needs a substrate registry name (it hosts "
                f"workers+2 assistant loops), got {type(substrate).__name__}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.fn = fn
        self.name = name or getattr(fn, "__name__", None) or "farm"
        self.capacity = capacity
        self.ordered = ordered
        self._substrate = substrate
        self._respawn = respawn
        self._emitter = _Emitter(self, capacity=1, substrate=substrate)
        self._workers: List[Stage] = [
            Stage(self._work, name=f"{self.name}-w{i}", capacity=capacity,
                  substrate=substrate, record=record)
            for i in range(workers)
        ]
        self._worker_in: List[SpscRing] = [SpscRing(capacity)
                                           for _ in range(workers)]
        #: Per-worker dealt ledger: (seq, item) pairs appended by the
        #: emitter before each push, retired by the collector on each
        #: release — the remainder at a worker's death is exactly its
        #: lost in-flight set, values included for replay.
        self._dealt: List[deque] = [deque() for _ in range(workers)]
        #: Quarantine flags: set by the collector to stop the emitter
        #: dealing to a dead worker's ring (collector sole writer).
        self._quarantined: List[bool] = [False] * workers
        #: Collector → emitter handback of lost (tag, item) pairs (1P1C:
        #: collector produces, emitter consumes). Sized to hold a full
        #: in-flight window (ring capacity + the in-worker item) so a
        #: single quarantine's re-emit never blocks on a busy emitter.
        self._redeal = SpscRing(capacity + 4)
        #: True while the collector runs a quarantine decision cycle —
        #: the emitter's STOP path waits it out (see _Emitter._shutdown).
        self._claiming = False
        self._gen: List[int] = [0] * workers
        self._retired: List[Stage] = []
        self._failures: List[WorkerFailure] = []
        #: Tags replayed after worker deaths, in recovery order (via
        #: emitter re-emit or inline at the collector). The acceptance
        #: invariant: equals the union of failures' lost_tags.
        self.reemitted_tags: List[int] = []
        #: Duplicate releases dropped by the collector's dedup ledger
        #: (0 in every non-pathological run: replay is exactly-once by
        #: construction, the ledger is the belt-and-braces proof).
        self.dup_dropped = 0
        self._collector = _Collector(self, capacity=capacity,
                                     substrate=substrate)
        self._collector.connect(SpscRing(1), _always_alive)  # loop is custom
        for w, ring in zip(self._workers, self._worker_in):
            w.connect(ring, self._emitter.alive)
            w.set_downstream_alive(self._collector.alive)
        self.workers = 0 if any(
            s.workers == 0
            for s in (self._emitter, *self._workers, self._collector)) else 1
        self.record = record

    def _work(self, tagged: tuple) -> tuple:
        seq, item = tagged
        if type(item) is StreamFailure:
            return tagged               # upstream failure: pass through
        try:
            return (seq, self.fn(item))
        except Exception as e:
            return (seq, StreamFailure(e, self.name))

    # -- supervision surface ------------------------------------------------
    @property
    def failures(self) -> Tuple[WorkerFailure, ...]:
        """Worker-death records, in detection order (collector-written;
        read from the driver after the run or between polls)."""
        return tuple(self._failures)

    def take_worker_failures(self) -> Tuple[WorkerFailure, ...]:
        """Drain the recorded failures (driver-side observation read,
        mirroring ``RelicPool.take_lane_failures``)."""
        out = tuple(self._failures)
        self._failures.clear()
        return out

    @property
    def lost_tags(self) -> Tuple[int, ...]:
        """Union of all recorded failures' lost tag sets, sorted."""
        out: List[int] = []
        for f in self._failures:
            out.extend(f.lost_tags)
        return tuple(sorted(out))

    # -- node interface (same shape as Stage) ------------------------------
    @property
    def out_ring(self) -> SpscRing:
        return self._collector.out_ring

    @property
    def items_in(self) -> int:
        return self._emitter.items_in

    @items_in.setter
    def items_in(self, v: int) -> None:        # inline-mode accounting
        self._emitter.items_in = v

    @property
    def items_out(self) -> int:
        return self._collector.items_out

    @items_out.setter
    def items_out(self, v: int) -> None:
        self._collector.items_out = v

    def connect(self, in_ring: SpscRing, upstream_alive) -> None:
        self._emitter.connect(in_ring, upstream_alive)

    def set_downstream_alive(self, probe) -> None:
        self._collector.set_downstream_alive(probe)

    def start(self) -> "Farm":
        # Sink-first (collector, workers, emitter) so every probe target
        # is already running when its prober's loop begins.
        self._collector.start()
        for w in self._workers:
            w.start()
        self._emitter.start()
        return self

    def alive(self) -> bool:
        return self._collector.alive()

    def error(self) -> Optional[BaseException]:
        for s in (self._collector, *self._workers, self._emitter):
            e = s.error()
            if e is not None:
                return e
        return None

    def _members(self) -> List[Stage]:
        """Every stage this farm ever hosted: the current roster plus the
        retired casualties of respawns (their scopes still need closing)."""
        return [self._emitter, *self._workers, self._collector,
                *self._retired]

    def join(self, timeout: Optional[float] = None) -> None:
        for s in self._members():
            s.join(timeout)

    def close(self) -> None:
        for s in self._members():
            s.close()

    def sleep_hint(self) -> None:
        for s in self._members():
            s.sleep_hint()

    def wake_up_hint(self) -> None:
        for s in self._members():
            s.wake_up_hint()

    def stats(self) -> dict:
        return {
            "name": self.name,
            "items_in": self.items_in,
            "items_out": self.items_out,
            "ordered": self.ordered,
            "respawn": self._respawn,
            "failures": len(self._failures),
            "reemitted": len(self.reemitted_tags),
            "dup_dropped": self.dup_dropped,
            "workers": [w.stats() for w in self._workers],
        }

    def __repr__(self) -> str:
        return (f"Farm({self.name!r}, workers={len(self._workers)}, "
                f"ordered={self.ordered}, respawn={self._respawn})")
