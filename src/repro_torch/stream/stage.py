"""One streaming stage: a Relic assistant looping over a pair of SPSC rings.

A :class:`Stage` is the unit FastFlow (Aldinucci et al., 2009) composes
networks from: one worker thread, one bounded input ring, one bounded
output ring. The stage's loop runs as a *single long-lived task* on its
own scheduling substrate (a ``TaskScope`` over ``"relic"`` by default), so
the whole streaming layer is built out of the paper's existing primitive —
an SPSC ring plus one assistant — rather than a new thread pool:

* the **driver** (or the upstream stage's assistant) is the sole producer
  of the stage's input ring;
* the stage's assistant is the sole consumer of its input ring and the
  sole producer of its output ring;
* the downstream stage's assistant (or the driver) is the sole consumer
  of the output ring.

Every ring is therefore strictly 1P1C *by construction* — the cached-index
fast paths of :class:`repro_torch.core.spsc.SpscRing` stay valid, and no lock or
MPMC queue appears anywhere on the item path (pinned by
``tests/test_stream.py``).

Waiting discipline (PR 8): every spin loop here is *bounded*. A popping
stage probes its upstream's liveness every ``_PROBE_EVERY_SPINS`` spins
and raises :class:`repro_torch.core.relic.RelicDeadError` (with fed/drained
diagnostics) instead of spinning forever on a ring nothing will ever fill;
a pushing stage symmetrically probes its downstream before waiting on a
ring nothing will ever drain. ``RELIC_SUPERVISE=0`` opts out, same switch
as the substrate.

In-band control flow:

* :data:`STOP` — end-of-stream sentinel. Forwarded exactly once by every
  stage, *after* its last data item (the GIL orders the ring write before
  the loop-exit flag, so a consumer that sees the stage dead re-pops once
  and still finds the STOP).
* :class:`StreamFailure` — an item whose ``fn`` raised. The marker flows
  downstream *in-stream* (later stages forward it untouched), preserving
  slot accounting: every item put in yields exactly one item (value or
  marker) out, so drivers never hang on a failed item. The driver-facing
  ``Pipeline.get()`` unwraps markers into raised exceptions.

Anything that is *not* an ``Exception`` (``SystemExit``,
``KeyboardInterrupt``) kills the stage loop itself — that is the
"assistant died" case, surfaced to whoever is waiting via the liveness
probes, exactly like a killed Relic assistant.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, List, Optional, Union

from repro_torch.core.relic import _PROBE_EVERY_SPINS, RelicDeadError
from repro_torch.core.schedulers import Scheduler, make_scheduler
from repro_torch.core.spsc import DEFAULT_CAPACITY, SpscRing
from repro_torch.runtime.config import (resolve_spin_pause_every,
                                  resolve_supervise_config)
from repro_torch.runtime.metrics import Gauge, LatencySeries
from repro_torch.tasks.api import TaskScope

__all__ = ["STOP", "StreamFailure", "StreamError", "StreamUsageError",
           "StageFailedError", "Stage", "worker_alive"]


class _Stop:
    """End-of-stream sentinel (singleton). Compared by identity."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<STOP>"


STOP = _Stop()


class StreamFailure:
    """In-stream marker for one item whose stage ``fn`` raised.

    Not an exception: it *flows* through the remaining stages (each
    forwards it untouched) so the one-in/one-out slot accounting that the
    bounded rings rely on survives failures. ``error`` is the original
    exception, ``stage`` the name of the stage that raised it.
    """

    __slots__ = ("error", "stage")

    def __init__(self, error: BaseException, stage: str):
        self.error = error
        self.stage = stage

    def __repr__(self) -> str:
        return f"StreamFailure({type(self.error).__name__}, stage={self.stage!r})"


class StreamError(RuntimeError):
    """A :class:`StreamFailure` unwrapped at the driver (``Pipeline.get``);
    the original stage exception is chained as ``__cause__``."""


class StreamUsageError(RuntimeError):
    """Structural misuse of the streaming API (wrong lifecycle order,
    un-hostable substrate, get without put)."""


class StageFailedError(RelicDeadError):
    """A stream stage died with in-flight items — and here is *which*.

    The stream-layer refinement of :class:`RelicDeadError`: on top of the
    fed/drained/lost counters it carries ``stage`` (the dead loop's name)
    and ``lost_tags`` — the exact sequence tags of the items that were
    dealt to the dead stage and never released, computed as
    dealt-minus-released by the farm collector's per-worker ledger. With
    the tags in hand a caller can re-submit precisely the lost work (the
    primitive ``Farm(respawn=True)``'s own re-emit is built on) instead of
    guessing from a bare count.
    """

    def __init__(self, lane: str, submitted: int, completed: int,
                 lost_tags: Iterable[int], stage: str = "") -> None:
        tags = tuple(sorted(lost_tags))
        super().__init__(lane, submitted, completed, len(tags))
        self.stage = stage
        self.lost_tags = tags


def worker_alive(sched: Scheduler) -> bool:
    """Best-effort liveness probe for a substrate's worker thread(s).

    Duck-typed against the in-repo adapters, the same surface the serve
    layer's ingest probe uses: chaos delegates to its inner substrate;
    relic adapters expose ``._rt.is_alive()``; the queue substrates expose
    their ``._t`` thread. Substrates with no probeable worker — the pool
    executor (workers never die) or RelicPool (its lanes self-supervise
    and respawn) — report alive, which only means the *bounded wait*
    cannot blame them; their own supervision still fires.
    """
    inner = getattr(sched, "_inner", None)
    if inner is not None:                      # chaos: pure delegation
        return worker_alive(inner)
    rt = getattr(sched, "_rt", None)
    if rt is not None:                         # relic family
        probe = getattr(rt, "is_alive", None)
        if probe is not None:
            return probe()
        return True                            # RelicPool: self-supervising
    t = getattr(sched, "_t", None)
    if t is not None:                          # spin / condvar worker thread
        return t.is_alive()
    return True                                # serial / pool / unknown


def _always_alive() -> bool:
    return True


class Stage:
    """One streaming stage: ``fn`` applied to every item flowing through.

    ``substrate`` is a registry name (the stage instantiates its *own*
    scheduler, so each stage gets its own assistant — the 1P1C invariant)
    or an unstarted/started ``Scheduler`` instance (adopted/borrowed by the
    stage's scope; the caller guarantees nothing else occupies its worker).
    Stages are wired by :class:`repro_torch.stream.Pipeline` / ``Farm`` — the
    composition layer assigns the input ring and both liveness probes; a
    bare Stage is not driveable on its own.

    ``record=True`` keeps a :class:`LatencySeries` of per-item ``fn`` time
    and a :class:`Gauge` of input-ring occupancy (sampled per item, by the
    consumer, so exact) — the shared ``repro_torch.runtime.metrics`` primitives,
    surfaced through ``stats()`` for the benchmark's stage rows.
    """

    def __init__(self, fn: Optional[Callable[[Any], Any]], *,
                 name: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 substrate: Union[str, Scheduler] = "relic",
                 record: bool = False):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", None) or "stage"
        self.capacity = capacity
        if isinstance(substrate, str):
            self._sched: Scheduler = make_scheduler(substrate)
        else:
            self._sched = substrate
        #: advertised worker count — 0 means "cannot host a loop" and makes
        #: the enclosing Pipeline degrade to fully-inline execution.
        self.workers: int = getattr(self._sched, "workers", 1)
        self._out = SpscRing(capacity)
        self._in: Optional[SpscRing] = None
        self._upstream_alive: Callable[[], bool] = _always_alive
        self._downstream_alive: Callable[[], bool] = _always_alive
        self._scope: Optional[TaskScope] = None
        self._handle = None
        # Single-writer counters (the stage's own assistant writes both).
        self.items_in = 0
        self.items_out = 0
        self.record = record
        self.latency: Optional[LatencySeries] = LatencySeries() if record else None
        self.occupancy: Optional[Gauge] = Gauge() if record else None
        # Park flag (plain bool, single writer = the driver via the hint
        # methods; GIL-published like the ring counters). The loop *spins*
        # while unparked — µs wake latency, the paper's discipline — but a
        # parked idle loop sleeps in ms ticks so a stopped-but-alive
        # network doesn't tax the host (sleep_hint's whole point).
        self._parked = False
        self._probe_every = (_PROBE_EVERY_SPINS
                             if resolve_supervise_config().supervise else 0)
        self._pause_every = resolve_spin_pause_every()
        # Opt-in chaos hook (None in production): consulted once per popped
        # data item; a fired switch kills the loop with the item popped but
        # unprocessed — the deterministic "stage died with in-flight work"
        # scenario. See repro_torch.runtime.chaos.StageKillSwitch.
        self._chaos_kill: Optional[Callable[[int], bool]] = None

    # -- wiring (called by the composition layer, before start) ------------
    @property
    def out_ring(self) -> SpscRing:
        """The ring this stage's assistant is the sole producer of."""
        return self._out

    def connect(self, in_ring: SpscRing,
                upstream_alive: Callable[[], bool]) -> None:
        """Assign the input ring (this stage becomes its sole consumer) and
        the probe for whoever produces into it."""
        self._in = in_ring
        self._upstream_alive = upstream_alive

    def set_downstream_alive(self, probe: Callable[[], bool]) -> None:
        """Assign the probe for whoever consumes the output ring."""
        self._downstream_alive = probe

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Stage":
        if self._handle is not None:
            raise StreamUsageError(f"stage {self.name!r} already started")
        if self._in is None:
            raise StreamUsageError(
                f"stage {self.name!r} has no input ring; compose it through "
                "Pipeline/Farm before starting")
        if self.workers == 0:
            raise StreamUsageError(
                f"stage {self.name!r}: a workers=0 substrate cannot host a "
                "stage loop (Pipeline runs such networks inline instead)")
        self._scope = TaskScope(self._sched)
        # The loop occupies the assistant for the stage's whole life, so
        # park/unpark hints from stop-start drivers must find it awake.
        self._scope.wake_up_hint()
        self._handle = self._scope.submit(self._run_loop)
        return self

    def alive(self) -> bool:
        """Can this stage still make progress? False once its loop exited
        (STOP processed, or a fatal error) or its worker thread died. A
        not-yet-started stage reports alive — ``Pipeline.start`` brings
        the network up sink-first, so a running stage may probe a sibling
        that is about to start; "never ran" must not read as "died"."""
        h = self._handle
        if h is None:
            return True
        return (not h._done) and worker_alive(self._sched)

    def error(self) -> Optional[BaseException]:
        """The loop's fatal error, if it exited with one (None otherwise —
        including while still running)."""
        h = self._handle
        return h._error if h is not None and h._done else None

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the loop task to exit (it does after forwarding STOP)."""
        if self._handle is not None:
            self._handle._wait(timeout)

    def close(self) -> None:
        """Release the substrate (idempotent). The loop must have exited —
        ``Pipeline.close`` drains STOP through the network first."""
        scope, self._scope = self._scope, None
        if scope is not None:
            scope.close()
        elif isinstance(self._sched, Scheduler) and self._handle is None:
            # Never started (e.g. the pipeline degraded to inline): closing
            # the never-started scheduler is a safe no-op for registry
            # substrates and releases nothing.
            try:
                self._sched.close()
            except Exception:
                pass

    # -- hints (advisory) --------------------------------------------------
    def sleep_hint(self) -> None:
        """Park the idle loop: while no item is available it sleeps in
        ~200us ticks instead of spinning hot — the streaming analogue of
        the paper's explicit between-parallel-sections hint. An item
        already in the ring is still processed immediately."""
        self._parked = True
        if self._scope is not None:
            self._scope.sleep_hint()

    def wake_up_hint(self) -> None:
        self._parked = False
        if self._scope is not None:
            self._scope.wake_up_hint()

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        out = {"name": self.name, "items_in": self.items_in,
               "items_out": self.items_out}
        if self.record and self.latency is not None and len(self.latency):
            pct = self.latency.percentiles()
            out["latency_us"] = {f"p{int(q)}": v * 1e6 for q, v in pct.items()}
            out["occupancy"] = self.occupancy.asdict()
        return out

    def __repr__(self) -> str:
        state = ("unstarted" if self._handle is None
                 else "alive" if self.alive() else "exited")
        return f"Stage({self.name!r}, {state}, in={self.items_in}, out={self.items_out})"

    # -- the loop (runs on this stage's assistant) -------------------------
    def _dead_upstream(self) -> RelicDeadError:
        return RelicDeadError(f"stream-stage {self.name!r} upstream",
                              self.items_in, self.items_in, 0)

    def _dead_downstream(self) -> RelicDeadError:
        return RelicDeadError(f"stream-stage {self.name!r} downstream",
                              self.items_in, self.items_out, len(self._out))

    def _run_loop(self) -> None:
        fn = self.fn
        pop = self._in.pop
        probe_every = self._probe_every
        pause_every = self._pause_every
        record = self.record
        spins = 0
        while True:
            item = pop()
            if item is None:
                # Bounded wait (PR 8 discipline): yield on the pause
                # cadence; every probe_every spins check the producer is
                # still there, re-popping once after a failed probe so an
                # item (or STOP) published right before death is drained.
                # A parked loop trades wake latency for idle CPU instead.
                spins += 1
                if self._parked:
                    time.sleep(200e-6)
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
                self._push_out(STOP)
                return
            if (self._chaos_kill is not None
                    and self._chaos_kill(self.items_in)):
                raise SystemExit("chaos: stage loop killed")
            self.items_in += 1
            if type(item) is StreamFailure:
                self._push_out(item)        # failed upstream: forward as-is
                self.items_out += 1
                continue
            if record:
                self.occupancy.observe(len(self._in))
                t0 = time.perf_counter()
            try:
                out = fn(item)
            except Exception as e:
                out = StreamFailure(e, self.name)
            if record:
                self.latency.add(time.perf_counter() - t0)
            self._push_out(out)
            self.items_out += 1

    def _push_out(self, item: Any) -> None:
        """Bounded-wait push into the output ring (backpressure point)."""
        if self._out.push(item):
            return
        probe_every = self._probe_every
        pause_every = self._pause_every
        spins = 0
        while True:
            spins += 1
            if spins % pause_every == 0:
                time.sleep(0)
            if (probe_every and spins % probe_every == 0
                    and not self._downstream_alive()):
                raise self._dead_downstream()
            if self._out.push(item):
                return
