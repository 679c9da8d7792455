"""Linear streaming pipeline: driver → stage → stage → … → driver.

Composition rules (docs/streaming.md walks through the why):

* The driver thread is the **sole producer** of the source ring and the
  **sole consumer** of the sink ring (the last node's output ring). Each
  inter-stage ring is produced by exactly one stage's assistant and
  consumed by exactly the next stage's assistant. Every ring in the
  network is therefore strictly 1P1C *by construction* — no lock, no MPMC
  queue, anywhere (pinned by ``tests/test_stream.py``).
* Backpressure is per-ring and bounded: a pipeline of N stages with ring
  capacity C holds at most ``(N+1) * C`` items in flight; a slow stage
  stalls its producer at the full ring, propagating backwards to ``put``.
* Substrates: each node built from a registry *name* gets its **own**
  scheduler instance (one assistant per stage — the invariant above). A
  single ``Scheduler`` *instance* cannot host N independent loops, so
  passing one fuses all callable stages into a single stage running the
  composed function on that instance. A ``workers=0`` substrate
  ("serial") cannot host any loop: the whole pipeline degrades to
  fully-inline execution on the driver thread — same results, same error
  marking, zero threads — which is also the natural A/B baseline.
* End-of-stream and failure are **in-band**: ``close()`` flows ``STOP``
  through every stage; an item whose stage fn raised travels on as a
  :class:`StreamFailure` marker so slot accounting never skews. ``get()``
  unwraps markers into :class:`StreamError`; ``get_raw()`` hands them
  back for callers that do their own accounting (PrefetchPipeline's
  error contract, CheckpointManager's wait()).
* Every driver-side wait is bounded by the PR 8 supervision discipline:
  liveness probe every ``_PROBE_EVERY_SPINS`` spins, ``RelicDeadError``
  with fed/drained diagnostics when a stage died, ``RELIC_SUPERVISE=0``
  opt-out.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterable, List, Optional, Sequence, Union

from repro_torch.core.relic import _PROBE_EVERY_SPINS, RelicDeadError
from repro_torch.core.schedulers import Scheduler
from repro_torch.core.spsc import DEFAULT_CAPACITY, SpscRing
from repro_torch.runtime.config import (resolve_spin_pause_every,
                                  resolve_supervise_config)
from repro_torch.stream.stage import (STOP, Stage, StreamError, StreamFailure,
                                StreamUsageError)

__all__ = ["Pipeline"]


def _compose(fns: Sequence[Callable[[Any], Any]]) -> Callable[[Any], Any]:
    """Left-to-right function composition (the fused-stage body)."""
    if len(fns) == 1:
        return fns[0]

    def fused(item: Any) -> Any:
        for fn in fns:
            item = fn(item)
        return item

    fused.__name__ = "+".join(getattr(f, "__name__", "fn") for f in fns)
    return fused


class Pipeline:
    """Compose stages into a driveable linear streaming network.

    ``stages`` mixes ready-made nodes (:class:`Stage`, ``Farm``) with bare
    callables; callables are wrapped into stages using the pipeline-level
    ``substrate``/``capacity``/``record`` defaults. ``capacity`` also sizes
    the source ring (the driver's put window).

    Driving::

        with Pipeline([parse, enrich, write]) as pipe:
            outs = pipe.run(items)          # feed + drain, order-preserving

    or item-at-a-time with explicit ``put()`` / ``get()`` (strict
    one-in/one-out accounting; ``get`` raises :class:`StreamError` for an
    item whose stage failed, ``get_raw`` returns the marker instead).

    ``supervisor=`` takes a :class:`repro_torch.runtime.fault.LaneSupervisor`
    sized to the stage count for advisory stalled/straggler *stage*
    detection — see :meth:`check_stages`.
    """

    def __init__(self, stages: Sequence[Union[Stage, Callable[[Any], Any], Any]],
                 *, substrate: Union[str, Scheduler] = "relic",
                 capacity: int = DEFAULT_CAPACITY, record: bool = False,
                 supervisor: Optional[Any] = None):
        if not stages:
            raise StreamUsageError("a Pipeline needs at least one stage")
        if isinstance(substrate, Scheduler):
            # One instance cannot host N loops: fuse the callables into a
            # single stage on it. Pre-built nodes keep their own substrates.
            callables = [s for s in stages if not hasattr(s, "out_ring")]
            if len(callables) == len(stages):
                stages = [Stage(_compose(list(stages)), name="fused",
                                capacity=capacity, substrate=substrate,
                                record=record)]
            elif callables:
                raise StreamUsageError(
                    "cannot mix bare callables with pre-built nodes when "
                    "fusing onto a single Scheduler instance; wrap the "
                    "callables in Stage(...) explicitly")
        self._nodes: List[Any] = [
            s if hasattr(s, "out_ring")
            else Stage(s, capacity=capacity, substrate=substrate, record=record)
            for s in stages
        ]
        self._inline = any(node.workers == 0 for node in self._nodes)
        self._source = SpscRing(capacity)
        self._sink: SpscRing = self._nodes[-1].out_ring
        self._inline_out: deque = deque()
        # Wire rings and liveness probes. The driver end is always "alive".
        prev_ring, prev_alive = self._source, _driver_alive
        for node in self._nodes:
            node.connect(prev_ring, prev_alive)
            prev_ring, prev_alive = node.out_ring, node.alive
        for up, down in zip(self._nodes, self._nodes[1:]):
            up.set_downstream_alive(down.alive)
        self._nodes[-1].set_downstream_alive(_driver_alive)
        self._fed = 0      # items put (driver-side single writer)
        self._got = 0      # items got
        self._started = False
        self._closed = False
        self._probe_every = (_PROBE_EVERY_SPINS
                             if resolve_supervise_config().supervise else 0)
        self._pause_every = resolve_spin_pause_every()
        # Advisory progress supervision (PR 8's LaneSupervisor lifted to
        # the stage stratum): one "lane" per stage, fed this pipeline's
        # fed/drained counters on every driver-side bounded-wait probe
        # (and on explicit check_stages() calls). Strictly advisory — the
        # *liveness* story is the bounded waits; this flags the cases they
        # cannot: a stage that is alive but wedged (stalled) or alive but
        # persistently slow (straggler).
        if supervisor is not None and supervisor.n_lanes != len(self._nodes):
            raise StreamUsageError(
                f"supervisor has {supervisor.n_lanes} lanes for "
                f"{len(self._nodes)} stages — size it with "
                "LaneSupervisor(n_lanes=len(stages), ...)")
        self._supervisor = supervisor
        if supervisor is not None and getattr(supervisor, "names", None) is None:
            supervisor.names = [node.name for node in self._nodes]

    # -- introspection -----------------------------------------------------
    @property
    def inline(self) -> bool:
        """True when a workers=0 substrate degraded the network to run
        synchronously on the driver thread."""
        return self._inline

    @property
    def nodes(self) -> tuple:
        return tuple(self._nodes)

    @property
    def sink_ring(self) -> SpscRing:
        """The ring the driver consumes (the last node's output ring)."""
        return self._sink

    def in_flight(self) -> int:
        return self._fed - self._got

    def stats(self) -> List[dict]:
        return [node.stats() for node in self._nodes]

    # -- advisory supervision (needs a supervisor= at construction) --------
    def check_stages(self) -> bool:
        """One supervision sweep: feed each stage's drained counter and its
        backlog (driver-fed minus stage-drained) to the supervisor. Cheap
        to call often — the supervisor samples once per heartbeat period.
        Returns True when a sample was actually taken. The driver's own
        bounded waits call this on their probe cadence, so a pipeline
        being driven supervises itself."""
        sup = self._supervisor
        if sup is None:
            return False
        completed = [node.items_out for node in self._nodes]
        outstanding = [max(self._fed - c, 0) for c in completed]
        return sup.observe(completed, outstanding)

    def stalled_stages(self) -> List[str]:
        """Names of stages with a backlog and no progress for ~2 heartbeat
        periods. Advisory: one long-running item and a wedged assistant
        look identical here — the bounded waits decide *dead*."""
        sup = self._supervisor
        if sup is None:
            return []
        return [self._nodes[i].name for i in sup.stalled()]

    def straggler_stages(self) -> List[str]:
        """Names of stages persistently slower than their peers (the
        StragglerMonitor's median/MAD z-score over per-period pace)."""
        sup = self._supervisor
        if sup is None:
            return []
        return [self._nodes[i].name for i in sup.stragglers()]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Pipeline":
        if self._started:
            raise StreamUsageError("Pipeline already started")
        if self._closed:
            raise StreamUsageError("Pipeline cannot restart after close()")
        self._started = True
        if not self._inline:
            # Sink-first so every stage's downstream probe refers to an
            # already-started node by the time its own loop runs.
            for node in reversed(self._nodes):
                node.start()
        return self

    def close(self) -> None:
        """Flow STOP through the network, join every stage loop, release
        the substrates. Idempotent; discards any undrained output items."""
        if self._closed:
            return
        self._closed = True
        if not self._started or self._inline:
            for node in self._nodes:
                node.close()
            return
        first, last = self._nodes[0], self._nodes[-1]
        try:
            # Feed STOP (bounded: give up if the head stage died — the
            # death cascades through the probes instead).
            spins = 0
            while not self._source.push(STOP):
                spins += 1
                if spins % self._pause_every == 0:
                    time.sleep(0)
                if (self._probe_every and spins % self._probe_every == 0
                        and not first.alive()):
                    break
            # Drain the sink until STOP comes out the far end (discarding
            # leftovers a caller abandoned), bounded by the tail stage's
            # liveness.
            spins = 0
            while True:
                item = self._sink.pop()
                if item is STOP:
                    break
                if item is not None:
                    continue
                spins += 1
                if spins % self._pause_every == 0:
                    time.sleep(0)
                if (self._probe_every and spins % self._probe_every == 0
                        and not last.alive()):
                    if self._sink.pop() is None:  # racing final publication
                        break
            for node in self._nodes:
                node.join(timeout=5)
        finally:
            for node in self._nodes:
                node.close()

    def __enter__(self) -> "Pipeline":
        if not self._started:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- hints (advisory, forwarded to every stage) ------------------------
    def pause(self) -> None:
        for node in self._nodes:
            node.sleep_hint()

    def resume(self) -> None:
        for node in self._nodes:
            node.wake_up_hint()

    # -- driving -----------------------------------------------------------
    def _check_driveable(self) -> None:
        if not self._started:
            raise StreamUsageError("Pipeline not started (use start() or 'with')")
        if self._closed:
            raise StreamUsageError("Pipeline is closed")

    def _apply_inline(self, item: Any) -> Any:
        for node in self._nodes:
            if type(item) is StreamFailure:
                return item
            node.items_in += 1
            try:
                item = node.fn(item)
            except Exception as e:
                item = StreamFailure(e, node.name)
            node.items_out += 1
        return item

    def put(self, item: Any) -> None:
        """Feed one item (bounded blocking on a full source ring)."""
        self._check_driveable()
        if self._inline:
            self._inline_out.append(self._apply_inline(item))
            self._fed += 1
            return
        if self._source.push(item):
            self._fed += 1
            return
        first = self._nodes[0]
        spins = 0
        while True:
            spins += 1
            if spins % self._pause_every == 0:
                time.sleep(0)
            if self._probe_every and spins % self._probe_every == 0:
                self.check_stages()
                if not first.alive():
                    raise self._dead(first)
            if self._source.push(item):
                self._fed += 1
                return

    def put_nowait(self, item: Any) -> bool:
        """Non-blocking feed; False when the source ring is full."""
        self._check_driveable()
        if self._inline:
            self.put(item)
            return True
        if self._source.push(item):
            self._fed += 1
            return True
        return False

    def get_raw(self) -> Any:
        """Next output item in stream order — a value or a
        :class:`StreamFailure` marker (bounded blocking)."""
        self._check_driveable()
        if self._inline:
            if not self._inline_out:
                raise StreamUsageError("get() with no item in flight")
            self._got += 1
            return self._inline_out.popleft()
        if self._fed == self._got:
            raise StreamUsageError("get() with no item in flight")
        last = self._nodes[-1]
        pop = self._sink.pop
        spins = 0
        while True:
            item = pop()
            if item is not None:
                if item is STOP:
                    raise StreamUsageError("stream already ended (STOP)")
                self._got += 1
                return item
            spins += 1
            if spins % self._pause_every == 0:
                time.sleep(0)
            if self._probe_every and spins % self._probe_every == 0:
                self.check_stages()
                if not last.alive():
                    item = pop()  # final re-pop: published right before death
                    if item is not None and item is not STOP:
                        self._got += 1
                        return item
                    raise self._dead(last)

    def get(self) -> Any:
        """Next output item; raises :class:`StreamError` (chaining the
        stage's original exception) if that item failed in-stream."""
        item = self.get_raw()
        if type(item) is StreamFailure:
            raise StreamError(
                f"stage {item.stage!r} failed on an item") from item.error
        return item

    def run(self, items: Iterable[Any], raw: bool = False) -> List[Any]:
        """Feed every item and return the outputs, in order.

        Feeding and draining interleave (non-blocking put, opportunistic
        sink pop), so bounded rings never deadlock the driver no matter
        how ``len(items)`` compares to the ring capacities. Raises
        :class:`StreamError` on the first failed item unless ``raw=True``,
        which instead leaves each failure's :class:`StreamFailure` marker
        in its output slot (strict one-in/one-out accounting). Requires
        one-in/one-out stages and no other items in flight.
        """
        unwrap = (lambda item: item) if raw else self._unwrap
        self._check_driveable()
        if self.in_flight():
            raise StreamUsageError("run() with items already in flight")
        if self._inline:
            out = []
            for item in items:
                self.put(item)
                out.append(unwrap(self.get_raw()))
            return out
        out: List[Any] = []
        it = iter(items)
        nxt: Any = _PENDING
        exhausted = False
        last = self._nodes[-1]
        push, pop = self._source.push, self._sink.pop
        spins = 0
        while True:
            progress = False
            if nxt is _PENDING and not exhausted:
                try:
                    nxt = next(it)
                except StopIteration:
                    exhausted = True
                    nxt = _PENDING
            if nxt is not _PENDING and push(nxt):
                self._fed += 1
                nxt = _PENDING
                progress = True
            item = pop()
            if item is not None:
                self._got += 1
                out.append(unwrap(item))
                progress = True
            if exhausted and nxt is _PENDING and self._fed == self._got:
                return out
            if progress:
                spins = 0
                continue
            spins += 1
            if spins % self._pause_every == 0:
                time.sleep(0)
            if self._probe_every and spins % self._probe_every == 0:
                self.check_stages()
                if not last.alive():
                    item = pop()
                    if item is not None and item is not STOP:
                        self._got += 1
                        out.append(unwrap(item))
                        spins = 0
                        continue
                    raise self._dead(last)

    def __iter__(self):
        """Drain whatever is in flight, in order (no further feeding)."""
        while self.in_flight() or (self._inline and self._inline_out):
            yield self.get()

    # -- internals ---------------------------------------------------------
    def _unwrap(self, item: Any) -> Any:
        if type(item) is StreamFailure:
            raise StreamError(
                f"stage {item.stage!r} failed on an item") from item.error
        return item

    def _dead(self, node: Any) -> RelicDeadError:
        err = RelicDeadError(f"stream-pipeline stage {node.name!r}",
                             self._fed, self._got, self._fed - self._got)
        # Chain the most downstream fatal stage error as the cause — the
        # probes cascade, so the root cause is the first dead stage.
        cause = None
        for n in self._nodes:
            e = n.error()
            if e is not None:
                cause = e
                break
        if cause is not None:
            err.__cause__ = cause
        return err


class _Pending:
    __slots__ = ()

    def __repr__(self) -> str:
        return "<PENDING>"


_PENDING = _Pending()


def _driver_alive() -> bool:
    return True
