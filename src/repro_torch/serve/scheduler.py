"""Continuous-batching scheduler loop on the Relic tasking substrate.

The serving shape of the paper's runtime: a single **scheduler loop thread**
owns a ``RelicPool``-backed scheduler (creates it, submits to it, closes it
— the pool's owner-thread contract) and runs the admit/dispatch/finalize
cycle:

1. **finalize** — observe ``Response.done()`` on in-flight requests (the
   assistant lanes publish via the lazy-Event flag; the loop never blocks
   on a barrier) and fold finished responses into ``ServeMetrics``;
2. **admit** — drain client SPSC rings up to the free batch budget
   (``RELIC_SERVE_BATCH_MAX`` minus in-flight), stamp ``admit_t``, shed
   requests whose deadline already passed (surfaced as
   ``deadline_exceeded``, never silently dropped), and submit the rest to
   the pool lanes via ``submit_many`` (lane striping + rebalance are the
   existing RelicPool machinery);
3. **park** — when idle long enough, publish a parked flag and sleep on an
   Event that ``ClientHandle.submit`` sets only when it observes the flag —
   the same advisory-hint philosophy as ``Relic.sleep_hint`` /
   ``wake_up_hint`` (paper §VI-B), so the submit hot path under load never
   touches the Event.

**Continuous batching** means there is no barrier between "batches": the
in-flight set is a sliding window. A request admitted while others are
running completes as soon as a lane finishes it — ``wait()`` is never
called on the pool while serving (RelicPool's fire-and-observe mode, whose
per-window error logs stay bounded by ring capacity).

Task errors are contained in ``_execute`` (the Response carries them);
a failed request never becomes a failed pool task, so the pool's
first-error-wins machinery stays quiet and serving continues.

**Retry & lane supervision (PR 8).** Requests submitted with
``idempotent=True`` are retried on failure under a deterministic
``RetryPolicy`` (bounded attempts, exponential backoff, seeded jitter): a
retry-eligible failure is never published — ``_execute`` marks the response
retry-pending and the loop re-admits it after the backoff, so the client
keeps waiting on the same future across attempts. On a ``RELIC_HEARTBEAT_MS``
cadence the loop polls the pool for dead lanes (``poll_lane_failures``);
when one died, recovery is *quiesce-then-diff*: stop admitting, let the
surviving lanes drain (``in_flight_estimate() → 0``, bounded), and the
in-flight responses that are neither finished nor retry-marked are exactly
the tasks the dead ring lost — idempotent ones are re-admitted, the rest
finish ``STATUS_ERROR`` carrying the ``LaneFailedError``. The pool itself
is constructed with ``respawn=True`` so capacity recovers. With
``RELIC_SUPERVISE=0`` all of this is off and the loop is byte-identical to
the PR 7 cycle.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.relic import RelicDeadError
from repro_torch.core.relic_pool import LaneFailedError, LaneFailure
from repro_torch.core.schedulers import make_scheduler
from repro_torch.runtime.config import (
    ServeConfig,
    resolve_serve_config,
    resolve_spin_pause_every,
    resolve_supervise_config,
)
from repro_torch.serve.ingest import ClientHandle, Ingest, ServeUsageError
from repro_torch.serve.metrics import ServeMetrics, now
from repro_torch.serve.request import (
    Response,
    STATUS_CANCELLED,
    STATUS_DEADLINE,
    STATUS_ERROR,
    STATUS_OK,
)
from repro_torch.serve.retry import RetryPolicy

# Idle loop iterations (no finalize, no admit) before the loop parks on the
# wake Event. Large enough that a loaded server never parks; small enough
# that an idle one stops burning the host within ~a millisecond.
_PARK_AFTER_IDLE_SPINS = 256
# Park timeout: an advisory-hint backstop, not the wake mechanism (the
# Event is); bounds stop() latency if every hint is missed.
_PARK_TIMEOUT_S = 0.05


class ServeScheduler:
    """Request server: per-client SPSC ingest → continuous batcher → lanes.

    Usage::

        with ServeScheduler(lanes=2) as server:
            client = server.open_client()
            resp = client.submit(fn, arg)
            value = resp.result()

    ``lanes=0`` runs a degenerate inline mode (admit → execute on the loop
    thread) used for tests that want serving semantics without threads.
    """

    def __init__(
        self,
        lanes: int = 2,
        capacity: Optional[int] = None,
        config: Optional[ServeConfig] = None,
        scheduler: str = "relic-pool",
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        if lanes < 0:
            raise ValueError(f"lanes must be >= 0, got {lanes}")
        self.lanes = lanes
        self._capacity = capacity
        self._scheduler_name = scheduler
        self.config = config or resolve_serve_config()
        self.retry_policy = retry_policy or RetryPolicy.from_config(
            self.config)
        sup = resolve_supervise_config()
        self._supervise = sup.supervise
        self._sweep_period_s = sup.heartbeat_ms / 1000.0
        self.metrics = ServeMetrics()
        self._wake_event = threading.Event()
        self._parked = False
        self.ingest = Ingest(self.config, wake=self._wake_from_client,
                             consumer_alive=self._loop_alive)
        # Robustness counters: loop-thread written, read by stats().
        self._retry_count = 0
        self._lane_failure_count = 0
        self._lost_requests = 0
        self._lane_health: Dict[str, tuple] = {
            "stalled": (), "stragglers": ()}
        self._in_flight: Dict[int, Response] = {}
        self._stop_requested = False
        self._drain_on_stop = True
        self._started = False
        self._closed = False
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_error: Optional[BaseException] = None
        self._ready = threading.Event()
        # The loop thread's scheduler, exposed for fault-injection tests
        # and the faults benchmark (kill-a-lane needs a handle on the live
        # pool). Owned by the loop thread: foreign threads may only arm
        # chaos hooks / read telemetry through it, never submit.
        self._sched: Optional[Any] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeScheduler":
        if self._started:
            raise ServeUsageError("ServeScheduler.start() called twice")
        self._started = True
        self._loop_thread = threading.Thread(
            target=self._loop, name="serve-scheduler", daemon=True)
        self._loop_thread.start()
        self._ready.wait()
        if self._loop_error is not None:
            raise self._loop_error
        return self

    def stop(self, drain: bool = True) -> None:
        """Shut down. ``drain=True`` finishes everything already submitted
        or queued; ``drain=False`` cancels queued requests (in-flight work
        still completes — lanes cannot be preempted)."""
        if not self._started or self._closed:
            return
        self._closed = True
        self.ingest.close()
        self._drain_on_stop = drain
        self._stop_requested = True
        self._wake_event.set()
        assert self._loop_thread is not None
        self._loop_thread.join()
        if self._loop_error is not None:
            raise self._loop_error

    def __enter__(self) -> "ServeScheduler":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- client side -------------------------------------------------------

    def open_client(self, client_id: Optional[str] = None) -> ClientHandle:
        return self.ingest.open_client(client_id)

    def stats(self) -> dict:
        """Live snapshot (callable from any thread, racy-but-consistent)."""
        snap = self.metrics.snapshot(rejected=self.ingest.total_rejected())
        snap["lanes"] = self.lanes
        snap["in_flight"] = len(self._in_flight)
        snap["pending"] = self.ingest.pending()
        snap["config"] = self.config.asdict()
        # Robustness telemetry (PR 8): retry volume, lane failures observed
        # and requests they lost, plus the latest supervision sweep's lane
        # health (stalled/straggler lane indexes — cached by the loop
        # thread so foreign readers never touch the supervisor's state).
        snap["retries"] = self._retry_count
        snap["lane_failures"] = self._lane_failure_count
        snap["lost_requests"] = self._lost_requests
        snap["stalled_lanes"] = list(self._lane_health["stalled"])
        snap["straggler_lanes"] = list(self._lane_health["stragglers"])
        snap["supervise"] = self._supervise
        return snap

    def _loop_alive(self) -> bool:
        """Is the scheduler loop still able to drain client rings? Used by
        the bounded block-admission wait in ``ClientHandle.submit``."""
        if not self._started:
            return False
        t = self._loop_thread
        return t is not None and t.is_alive()

    # -- wake hint (client threads) ---------------------------------------

    def _wake_from_client(self) -> None:
        # One flag read per submit; Event.set only on park transitions —
        # the loaded hot path never touches the Event.
        if self._parked:
            self._wake_event.set()

    # -- execution (assistant lanes) --------------------------------------

    def _execute(self, resp: Response) -> None:
        """Run one request on a pool lane. Never raises: the Response is
        the error channel, so a failing request cannot poison the lane."""
        req = resp.request
        first_t: Optional[float] = None
        try:
            value = req.fn(*req.args)
            if hasattr(value, "__next__"):
                # Streaming work: the first yielded item stamps
                # first-result time (TTFT for token serving); the
                # response value is the collected stream.
                items = []
                for item in value:
                    if first_t is None:
                        first_t = now()
                        resp.first_result_t = first_t
                    items.append(item)
                value = items
            t = now()
            if first_t is None:
                resp.first_result_t = t
            status = STATUS_OK
            if req.deadline_t is not None and t > req.deadline_t:
                status = STATUS_DEADLINE
            resp._finish(status, value=value, complete_t=t)
        except BaseException as exc:  # noqa: BLE001 - the future carries it
            if (req.idempotent
                    and self.retry_policy.allows(resp.attempts)
                    and (req.deadline_t is None or now() <= req.deadline_t)):
                # Retry-eligible: do NOT publish. Store the error, flip the
                # retry flag (in that order — the flag is the publication
                # point for the loop thread), and let the loop re-admit
                # after backoff. The client keeps waiting on this future.
                resp._retry_error = exc
                resp._retry_pending = True
            else:
                resp._finish(STATUS_ERROR, error=exc, complete_t=now())

    # -- scheduler loop ----------------------------------------------------

    def _dispatch(self, sched: Any, submits: List[tuple],
                  supervised: bool) -> bool:
        """Push a batch at the substrate. Returns True if the substrate
        reported lane death mid-dispatch (recoverable when supervised: the
        quiesce-then-diff sweep classifies every in-flight response,
        including any of this batch that never reached a ring)."""
        if sched is None:
            for fn, args, _ in submits:
                fn(*args)
            return False
        try:
            sched.submit_many(submits)
        except RelicDeadError:
            if not supervised:
                raise
            return True
        return False

    def _recover_lane_failures(
        self,
        sched: Any,
        failures: List[LaneFailure],
        in_flight: Dict[int, Response],
        retry_queue: List[Response],
        metrics: ServeMetrics,
    ) -> None:
        """Quiesce-then-diff lane-death recovery (loop thread only).

        Stop admitting, let the surviving lanes drain everything still
        live (``in_flight_estimate()`` counts submitted-but-unfinished
        tasks pool-wide, with the quarantined ring's losses already
        subtracted — it reaches zero exactly when every *surviving* task
        has published). The in-flight responses that are then neither
        finished nor retry-marked are precisely the ones the dead ring
        lost: idempotent ones re-enter via the retry queue, the rest
        finish ``STATUS_ERROR`` carrying the ``LaneFailedError``.
        """
        self._lane_failure_count += len(failures)
        deadline = now() + 5.0
        while sched.in_flight_estimate() > 0 and now() < deadline:
            more = sched.poll_lane_failures()
            if more:
                self._lane_failure_count += len(more)
                failures.extend(more)
            time.sleep(0)
        err = LaneFailedError(tuple(failures))
        policy = self.retry_policy
        t = now()
        for resp in list(in_flight.values()):
            if resp.done() or resp._retry_pending:
                continue
            req = resp.request
            del in_flight[req.rid]
            self._lost_requests += 1
            if (req.idempotent and policy.allows(resp.attempts)
                    and (req.deadline_t is None or t <= req.deadline_t)):
                resp._retry_error = err
                resp._retry_at = t + policy.delay(req.rid, resp.attempts)
                retry_queue.append(resp)
                self._retry_count += 1
            else:
                resp._finish(STATUS_ERROR, error=err, complete_t=t)
                metrics.note_complete(resp)

    def _loop(self) -> None:
        sched = None
        try:
            if self.lanes > 0:
                kwargs: Dict[str, Any] = {"lanes": self.lanes}
                if self._capacity is not None:
                    kwargs["capacity"] = self._capacity
                try:
                    # Pool-family substrates grow capacity back after a
                    # lane death; substrates without the kwarg (the plain
                    # pair, thread pools) reject it and are built as-is.
                    sched = make_scheduler(
                        self._scheduler_name, respawn=True, **kwargs)
                except TypeError:
                    sched = make_scheduler(self._scheduler_name, **kwargs)
                sched.start()
                self._sched = sched
        except BaseException as exc:  # noqa: BLE001 - surface via start()
            self._loop_error = exc
            self._ready.set()
            return
        self._ready.set()

        metrics = self.metrics
        ingest = self.ingest
        in_flight = self._in_flight
        batch_max = self.config.batch_max
        pause_every = resolve_spin_pause_every()
        policy = self.retry_policy
        retry_queue: List[Response] = []
        supervised = (self._supervise and sched is not None
                      and hasattr(sched, "poll_lane_failures"))
        next_sweep_t = now() + self._sweep_period_s if supervised else 0.0
        idle_spins = 0
        try:
            while True:
                progressed = False

                # 1. finalize: observe completions without any barrier, and
                # collect retry-marked failures for backed-off re-admission.
                if in_flight:
                    done: List[Response] = []
                    marked: List[Response] = []
                    for r in in_flight.values():
                        if r.done():
                            done.append(r)
                        elif r._retry_pending:
                            marked.append(r)
                    for resp in done:
                        del in_flight[resp.request.rid]
                        metrics.note_complete(resp)
                    if marked:
                        t = now()
                        for resp in marked:
                            resp._retry_pending = False
                            del in_flight[resp.request.rid]
                            resp._retry_at = t + policy.delay(
                                resp.request.rid, resp.attempts)
                            retry_queue.append(resp)
                            self._retry_count += 1
                    if done or marked:
                        progressed = True

                # 2a. re-admit: due retries rejoin the window ahead of new
                # arrivals (they have already burned queue + lane time).
                if retry_queue:
                    t = now()
                    budget = batch_max - len(in_flight)
                    if budget > 0 and any(
                            r._retry_at <= t for r in retry_queue):
                        due: List[Response] = []
                        later: List[Response] = []
                        for r in retry_queue:
                            if r._retry_at <= t and len(due) < budget:
                                due.append(r)
                            else:
                                later.append(r)
                        retry_queue[:] = later
                        progressed = True
                        submits = []
                        for resp in due:
                            req = resp.request
                            if (req.deadline_t is not None
                                    and t > req.deadline_t):
                                # Out of time: surface the *failure* (more
                                # informative than the deadline it caused).
                                resp._finish(STATUS_ERROR,
                                             error=resp._retry_error,
                                             complete_t=t)
                                metrics.note_complete(resp)
                                continue
                            resp.attempts += 1
                            resp.first_result_t = None
                            in_flight[req.rid] = resp
                            submits.append((self._execute, (resp,), {}))
                        if submits and self._dispatch(
                                sched, submits, supervised):
                            next_sweep_t = 0.0

                # 2b. admit: fill the sliding window mid-stream.
                budget = batch_max - len(in_flight)
                if budget > 0:
                    batch = ingest.poll(budget)
                    if batch:
                        progressed = True
                        t = now()
                        submits = []
                        for resp in batch:
                            req = resp.request
                            req.admit_t = t
                            metrics.admitted += 1
                            if (req.deadline_t is not None
                                    and t > req.deadline_t):
                                # Shed without running: the SLO violation
                                # is surfaced, the lane time is not spent.
                                resp._finish(STATUS_DEADLINE, complete_t=t)
                                metrics.note_complete(resp)
                                continue
                            resp.attempts += 1
                            in_flight[req.rid] = resp
                            submits.append((self._execute, (resp,), {}))
                        if submits and self._dispatch(
                                sched, submits, supervised):
                            next_sweep_t = 0.0
                        metrics.queue_depth.observe(ingest.pending())
                        metrics.batch_occupancy.observe(len(in_flight))

                # 2c. supervise: poll lane liveness/health on the heartbeat
                # cadence; dead lanes trigger quiesce-then-diff recovery.
                if supervised and now() >= next_sweep_t:
                    next_sweep_t = now() + self._sweep_period_s
                    failures = sched.poll_lane_failures()
                    self._lane_health = {
                        "stalled": tuple(sched.stalled_lanes()),
                        "stragglers": tuple(sched.straggler_lanes()),
                    }
                    if failures:
                        self._recover_lane_failures(
                            sched, list(failures), in_flight, retry_queue,
                            metrics)
                        progressed = True

                if self._stop_requested:
                    if not self._drain_on_stop:
                        break
                    if (not in_flight and not ingest.pending()
                            and not retry_queue):
                        break

                if progressed:
                    idle_spins = 0
                    continue

                # 3. idle: spin briefly, then park on the wake Event.
                idle_spins += 1
                if idle_spins % pause_every == 0:
                    time.sleep(0)
                if (idle_spins >= _PARK_AFTER_IDLE_SPINS and not in_flight
                        and not retry_queue):
                    self._wake_event.clear()
                    self._parked = True
                    try:
                        # Double-check after publishing the flag: a submit
                        # that missed it must be visible in the rings now.
                        if not ingest.pending() and not self._stop_requested:
                            if sched is not None:
                                sched.sleep_hint()
                            self._wake_event.wait(_PARK_TIMEOUT_S)
                            if sched is not None:
                                sched.wake_up_hint()
                    finally:
                        self._parked = False
                    idle_spins = 0
        except BaseException as exc:  # noqa: BLE001 - surface via stop()
            self._loop_error = exc
        finally:
            # Cancel whatever the stop mode left behind (queued requests on
            # drain=False, everything on a loop error).
            for resp in ingest.poll(1 << 30):
                resp._finish(STATUS_CANCELLED, complete_t=now())
                metrics.note_complete(resp)
            # Pending retries are not re-run once the loop is exiting: they
            # finish with the failure that queued them (drain=True never
            # reaches here with a non-empty queue — the stop condition
            # waits it out).
            for resp in retry_queue:
                resp._finish(STATUS_ERROR, error=resp._retry_error,
                             complete_t=now())
                metrics.note_complete(resp)
            retry_queue.clear()
            deadline = now() + 5.0
            for resp in list(in_flight.values()):
                # In-flight work cannot be preempted; wait for the lanes to
                # publish, then account. Bounded: if the pool broke mid-run
                # the stragglers are force-cancelled after the deadline. A
                # response that goes retry-pending during shutdown will
                # never be re-admitted — publish its stored failure now
                # rather than burning the whole drain deadline on it.
                while (not resp.done() and not resp._retry_pending
                       and now() < deadline):
                    time.sleep(0)
                if resp._retry_pending:
                    resp._finish(STATUS_ERROR, error=resp._retry_error,
                                 complete_t=now())
                elif not resp.done():
                    resp._finish(STATUS_CANCELLED, complete_t=now())
                del in_flight[resp.request.rid]
                metrics.note_complete(resp)
            if sched is not None:
                try:
                    sched.close()
                except BaseException as exc:  # noqa: BLE001
                    if self._loop_error is None:
                        self._loop_error = exc
