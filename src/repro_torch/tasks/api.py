"""Structured tasking façade over ``repro_torch.core.schedulers``.

The paper's thesis is that fine-grained task parallelism pays off only when
*expressing* a task is nearly free (§VI: Relic's submit is a ring push).
The raw ``Scheduler`` contract from ``repro_torch.core.schedulers`` keeps that
cost profile but pushes real ergonomics onto every caller: results come
back only through caller-managed shared state, and of N task errors only
the first survives ``wait()``. This module is the high-level layer the
FastFlow line of work (Aldinucci et al., 2009) argues such runtimes need —
a small structured-concurrency surface that every in-repo consumer (and
every future workload) targets, leaving raw ``submit()``/``wait()`` as the
substrate SPI.

The surface:

  * :class:`TaskScope` — context manager bound to a substrate (registry
    name or ``Scheduler`` instance). Scope exit is the barrier. Task
    errors are aggregated per scope and re-raised together (a
    :class:`TaskGroupError` when more than one task failed) instead of
    the SPI's first-error-wins.
  * ``scope.submit(fn, *args) -> TaskHandle`` — a lightweight future with
    ``result()`` / ``exception()`` / ``done()``.
  * :func:`parallel_for` — worksharing loop tasking (Maroñas et al., 2020)
    with explicit ``grain`` chunking; the calling thread runs the final
    chunk itself (the paper's producer-participates pattern, §VI).
  * :func:`map_reduce` — ``parallel_for`` with per-chunk local reduction
    and a deterministic chunk-order combine on the calling thread.
  * :class:`TaskGraph` — dependency-graph builder (``graph.task(name, fn,
    deps=...)``) that executes in topological wavefronts over a scope and
    hands results back through handles — no shared results dict, no lock.

Grain-size guidance (paper §IV: task bodies of 0.4–6.4 µs): pick ``grain``
so one *chunk* amounts to at least a few microseconds of work — at Python
submit overheads, per-index tasks only make sense when the body itself is
µs-scale (a JAX dispatch, a NumPy kernel, file I/O).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.core.schedulers import (USAGE_ERRORS, Scheduler,
                                   SchedulerUsageError, make_scheduler)

__all__ = [
    "TaskScope",
    "TaskHandle",
    "TaskGraph",
    "TaskGroupError",
    "TaskCancelledError",
    "parallel_for",
    "map_reduce",
]


class TaskGroupError(RuntimeError):
    """Every task exception from one scope window, re-raised together.

    Python 3.10-compatible stand-in for ``ExceptionGroup``: the individual
    exceptions (in task-completion order) are on ``.exceptions``.
    """

    def __init__(self, exceptions: Iterable[BaseException]):
        self.exceptions: Tuple[BaseException, ...] = tuple(exceptions)
        kinds = ", ".join(type(e).__name__ for e in self.exceptions)
        super().__init__(f"{len(self.exceptions)} tasks failed ({kinds})")


class TaskCancelledError(RuntimeError):
    """The task never ran (an upstream dependency failed)."""


class TaskHandle:
    """Lightweight future for one submitted task.

    Completion is signalled by the thread that ran the task, so
    ``result()`` blocks without involving the scheduler barrier — safe to
    call from the owning thread at any point, before or after the scope's
    barrier. A handle whose task failed re-raises that task's exception;
    the scope-level aggregate still fires at the next barrier regardless
    of which handles were inspected.

    Allocation-slim by design: completion is a plain flag write, and the
    ``threading.Event`` (a Condition + Lock allocation, the dominant cost
    of the PR 2 handle) is created lazily on the first *blocking* wait.
    The common fire-and-barrier pattern — submit, ``barrier()``, then read
    results — never allocates one.
    """

    __slots__ = ("label", "_done", "_event", "_result", "_error")

    # Shared creation lock for the lazy event: taken only on the slow
    # (blocking-wait) path, so it costs the hot path nothing.
    _event_init_lock = threading.Lock()

    def __init__(self, label: Optional[str] = None):
        self.label = label
        self._done = False
        self._event: Optional[threading.Event] = None
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        """True once the task has finished (successfully or not)."""
        return self._done

    def _wait(self, timeout: Optional[float] = None) -> bool:
        """Block until finished (lazily materializing the event); returns
        False only on timeout."""
        if self._done:
            return True
        ev = self._event
        if ev is None:
            with TaskHandle._event_init_lock:
                ev = self._event
                if ev is None:
                    ev = threading.Event()
                    self._event = ev
            if self._done:
                # The finisher may have completed between the flag check
                # and the event install, missing the fresh event: make the
                # event agree with the flag so later waiters pass too.
                ev.set()
                return True
        return ev.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until completion; return the value or re-raise the task's
        exception. ``timeout`` (seconds) raises ``TimeoutError``."""
        if not self._wait(timeout):
            raise TimeoutError(f"task {self.label!r} still pending")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        """Block until completion; return the exception (or None)."""
        if not self._wait(timeout):
            raise TimeoutError(f"task {self.label!r} still pending")
        return self._error

    def __repr__(self) -> str:
        state = ("error" if self._error is not None else
                 "done" if self._done else "pending")
        return f"TaskHandle({self.label!r}, {state})"

    # -- internal (written by the thread that runs the task) ---------------
    def _finish(self, result: Any, error: Optional[BaseException]) -> None:
        self._result = result
        self._error = error
        self._done = True        # the flag is the completion publication
        ev = self._event
        if ev is not None:       # only waiters pay for event signalling
            ev.set()

    def _reset(self) -> None:
        self._done = False
        self._event = None
        self._result = None
        self._error = None


class TaskScope:
    """Structured-concurrency window over one scheduling substrate.

    ::

        with TaskScope("relic") as scope:          # or "spin"/"condvar"/...
            h = scope.submit(fn, x)                # -> TaskHandle
            parallel_for(scope, n, body, grain=g)  # worksharing loop
            ...                                    # main thread's own share
        # scope exit == barrier: everything completed, errors raised here

    ``scheduler`` is a registry name (the scope instantiates, starts and
    closes the substrate) or a ``Scheduler`` instance — started instances
    are *borrowed* (the scope barriers on them but never closes them, so a
    long-lived substrate can host many scopes), not-yet-started instances
    are adopted (started now, closed with the scope).

    Error model: the task wrapper captures every task exception, so the
    substrate's first-error-wins ``wait()`` never fires for scope tasks.
    ``barrier()`` (and scope exit) re-raises a single failure as itself
    and multiple failures as :class:`TaskGroupError` listing all of them.
    If the ``with`` body itself raises, in-flight tasks are still drained
    but the body's exception wins; task errors stay observable on
    ``scope.errors`` until the next ``barrier()``.

    A scope is also usable without ``with`` (e.g. a long-lived member of
    ``CheckpointManager``): call ``barrier()`` per window and ``close()``
    at end of life. ``submit``/``barrier`` are owning-thread-only and
    tasks must not submit, mirroring the SPI (paper §VI-A).
    """

    def __init__(self, scheduler: Union[str, Scheduler] = "relic",
                 **scheduler_kwargs: Any):
        if isinstance(scheduler, str):
            self._sched: Scheduler = make_scheduler(scheduler, **scheduler_kwargs)
            self._sched.start()
            self._owns = True
        else:
            if scheduler_kwargs:
                raise TypeError(
                    "scheduler kwargs only apply when constructing by name; "
                    f"got an instance plus {sorted(scheduler_kwargs)}")
            self._sched = scheduler
            try:
                self._sched.start()
                self._owns = True           # adopted: we started it
            except USAGE_ERRORS:
                self._owns = False          # borrowed: already running
        self.substrate: str = getattr(self._sched, "name", type(self._sched).__name__)
        # The substrate's advertised concurrent-worker count (optional SPI
        # property, default 1): worksharing constructs derive their default
        # grain from it — producer + workers shares, the paper's
        # producer-participates shape generalized past the SMT pair.
        self.workers: int = getattr(self._sched, "workers", 1)
        # Feature-detect the batch SPI once: registry substrates all have it
        # (natively or via the base-class fallback), but a borrowed
        # third-party Scheduler may predate submit_many.
        self._submit_many = getattr(self._sched, "submit_many", None)
        self._errors: List[BaseException] = []
        self._err_lock = threading.Lock()
        self._closed = False

    # -- introspection -----------------------------------------------------
    @property
    def scheduler(self) -> Scheduler:
        """The underlying substrate (the low-level SPI escape hatch)."""
        return self._sched

    @property
    def stats(self):
        return self._sched.stats

    @property
    def errors(self) -> Tuple[BaseException, ...]:
        """Task errors captured since the last ``barrier()`` (unraised)."""
        with self._err_lock:
            return tuple(self._errors)

    # -- submission --------------------------------------------------------
    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> TaskHandle:
        """Enqueue ``fn(*args, **kwargs)`` on the substrate; returns a
        :class:`TaskHandle` that completes when the task does."""
        handle = TaskHandle(label=getattr(fn, "__name__", None))
        self._submit_into(handle, fn, args, kwargs)
        return handle

    def _submit_into(self, handle: TaskHandle, fn: Callable[..., Any],
                     args: tuple, kwargs: dict) -> None:
        if self._closed:
            raise SchedulerUsageError("submit() on a closed TaskScope")
        self._sched.submit(self._run_into, handle, fn, args, kwargs)

    def _submit_raw_many(self, tasks: List[tuple]) -> None:
        """Push pre-packed ``(fn, args, kwargs)`` tasks through the batch
        SPI (worksharing constructs own their error capture and join, so
        no handles and no per-task wrapper are involved)."""
        if self._closed:
            raise SchedulerUsageError("submit on a closed TaskScope")
        if self._submit_many is not None:
            self._submit_many(tasks)
        else:  # borrowed pre-submit_many substrate: equivalent loop
            for fn, args, kwargs in tasks:
                self._sched.submit(fn, *args, **kwargs)

    def _run_into(self, handle: TaskHandle, fn: Callable[..., Any],
                  args: tuple, kwargs: dict) -> None:
        # Runs on a worker (or, for producer-participates, the owning
        # thread). Exceptions are captured for the scope aggregate, so the
        # substrate's single-error channel stays empty.
        try:
            out = fn(*args, **kwargs)
        except BaseException as e:
            with self._err_lock:
                self._errors.append(e)
            handle._finish(None, e)
        else:
            handle._finish(out, None)

    def run_inline(self, fn: Callable[..., Any], *args: Any,
                   **kwargs: Any) -> TaskHandle:
        """Run ``fn`` on the calling thread under the scope's error
        aggregation (the producer-participates half of a wavefront)."""
        if self._closed:
            raise SchedulerUsageError("run_inline() on a closed TaskScope")
        handle = TaskHandle(label=getattr(fn, "__name__", None))
        self._run_into(handle, fn, args, kwargs)
        return handle

    # -- synchronization ---------------------------------------------------
    def barrier(self) -> None:
        """Block until every task submitted so far has completed, then
        re-raise captured task errors (one directly, several as
        :class:`TaskGroupError`) and clear them. The scope stays usable."""
        self._sched.wait()
        self._raise_errors()

    def _raise_errors(self) -> None:
        with self._err_lock:
            errs, self._errors = self._errors, []
        if len(errs) == 1:
            raise errs[0]
        if errs:
            raise TaskGroupError(errs)

    def _drain(self) -> None:
        """Wait for in-flight tasks without raising (body-exception path)."""
        try:
            self._sched.wait()
        except BaseException:
            pass  # body error wins; task errors remain on scope.errors

    def _wait_handles(self, handles: List[TaskHandle]) -> None:
        """Join exactly these tasks and raise only *their* errors (removed
        from the scope aggregate so they don't re-raise at the barrier).
        Errors from unrelated scope tasks stay queued for ``barrier()`` —
        this is how worksharing constructs avoid misattributing a failed
        sibling to the loop."""
        if not all(h._done for h in handles):
            # Advisory hints must never deadlock a join (same rule as the
            # SPI's wait()): un-park a sleeping worker before blocking.
            self._sched.wake_up_hint()
        for h in handles:
            h._wait()
        errs = [h._error for h in handles if h._error is not None]
        if not errs:
            return
        with self._err_lock:
            for e in errs:
                try:
                    self._errors.remove(e)   # identity: default __eq__
                except ValueError:
                    pass                     # already consumed by a barrier
        if len(errs) == 1:
            raise errs[0]
        raise TaskGroupError(errs)

    # -- hints (paper §VI-B, advisory) -------------------------------------
    def sleep_hint(self) -> None:
        self._sched.sleep_hint()

    def wake_up_hint(self) -> None:
        self._sched.wake_up_hint()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Idempotent; closes the substrate only if this scope owns it."""
        if self._closed:
            return
        self._closed = True
        if self._owns:
            self._sched.close()

    def __enter__(self) -> "TaskScope":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.barrier()
            else:
                self._drain()
        finally:
            self.close()


# ------------------------------------------------------------- worksharing

class _ChunkJoin:
    """Single countdown latch shared by every chunk of one worksharing loop
    (the worksharing-task join of Maroñas et al., 2020): one allocation per
    *loop* instead of one ``TaskHandle`` + ``Event`` per chunk. Chunk errors
    collect here, in completion order, and never enter the scope aggregate —
    the loop raises its own errors and a sibling's never misattribute."""

    __slots__ = ("_remaining", "_lock", "_event", "errors")

    def __init__(self, count: int):
        self._remaining = count
        self._lock = threading.Lock()
        self._event = threading.Event()
        self.errors: List[BaseException] = []

    def finish(self, error: Optional[BaseException] = None) -> None:
        with self._lock:
            if error is not None:
                self.errors.append(error)
            self._remaining -= 1
            done = self._remaining <= 0
        if done:
            self._event.set()

    def pending(self) -> bool:
        return self._remaining > 0

    def wait(self) -> None:
        self._event.wait()

    def raise_errors(self) -> None:
        errs = self.errors
        if len(errs) == 1:
            raise errs[0]
        if errs:
            raise TaskGroupError(errs)


def _chunk_ranges(n: int, grain: int) -> List[Tuple[int, int]]:
    return [(lo, min(lo + grain, n)) for lo in range(0, n, grain)]


def _resolve_grain(n: int, grain: Optional[int], workers: int = 1) -> int:
    if grain is None:
        # Default: one near-equal share per execution context — the
        # substrate's advertised workers plus the producer itself (the
        # paper's producer-participates shape, §VI, generalized past the
        # SMT pair: workers=1 keeps the historical split-in-two; a 4-lane
        # pool splits in five; serial's workers=0 runs the loop inline).
        # Explicit grain is the knob the grain-sweep benchmark turns
        # (benchmarks/run.py --only grain).
        return max(1, math.ceil(n / (max(workers, 0) + 1)))
    if grain <= 0:
        raise ValueError(f"grain must be positive, got {grain}")
    return grain


def parallel_for(scope: TaskScope, n: int, body: Callable[[int], Any],
                 *, grain: Optional[int] = None) -> None:
    """Worksharing loop: run ``body(i)`` for ``i in range(n)`` over the
    scope's substrate, chunked by ``grain`` indices per task.

    All chunks but the last go down in one ``submit_many`` burst; the
    calling thread runs the final chunk itself (producer-participates,
    paper §VI), then joins the loop on a single shared countdown latch —
    on return every index has run, and body exceptions (only the loop's,
    never an unrelated sibling task's) are raised under the scope's
    aggregation rules. With ``n <= grain`` the whole loop runs inline on
    the caller (zero submissions, zero allocations); ``n == 0`` is a pure
    no-op.
    """
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    if n == 0:
        return
    ranges = _chunk_ranges(n, _resolve_grain(n, grain, scope.workers))
    if len(ranges) == 1:
        if scope._closed:
            raise SchedulerUsageError("parallel_for() on a closed TaskScope")
        for i in range(n):
            body(i)
        return

    join = _ChunkJoin(len(ranges))

    def run_chunk(lo: int, hi: int) -> None:
        try:
            for i in range(lo, hi):
                body(i)
        except BaseException as e:
            join.finish(e)
        else:
            join.finish()

    scope._submit_raw_many([(run_chunk, (lo, hi), {})
                            for lo, hi in ranges[:-1]])
    run_chunk(*ranges[-1])
    if join.pending():
        # Advisory hints must never deadlock a join (the SPI wait() rule).
        scope._sched.wake_up_hint()
    join.wait()
    join.raise_errors()


_MISSING = object()


def map_reduce(scope: TaskScope, n: int, map_fn: Callable[[int], Any],
               reduce_fn: Callable[[Any, Any], Any], *,
               init: Any = _MISSING, grain: Optional[int] = None) -> Any:
    """Chunked map + reduce: each chunk folds ``map_fn`` over its indices
    with ``reduce_fn`` locally (the caller runs the final chunk), then the
    partials are combined on the calling thread in chunk order — so the
    result is deterministic for any associative ``reduce_fn``, on every
    substrate. ``init`` seeds the combine (required when ``n == 0``)."""
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    if n == 0:
        if init is _MISSING:
            raise ValueError("map_reduce over an empty range requires init")
        return init
    ranges = _chunk_ranges(n, _resolve_grain(n, grain, scope.workers))
    partials: List[Any] = [None] * len(ranges)  # one slot per chunk: no lock
    join = _ChunkJoin(len(ranges))

    def run_chunk(ci: int, lo: int, hi: int) -> None:
        try:
            acc = map_fn(lo)
            for i in range(lo + 1, hi):
                acc = reduce_fn(acc, map_fn(i))
            partials[ci] = acc
        except BaseException as e:
            join.finish(e)
        else:
            join.finish()

    if len(ranges) > 1:
        scope._submit_raw_many([(run_chunk, (ci, lo, hi), {})
                                for ci, (lo, hi) in enumerate(ranges[:-1])])
    elif scope._closed:
        raise SchedulerUsageError("map_reduce() on a closed TaskScope")
    run_chunk(len(ranges) - 1, *ranges[-1])
    if join.pending():
        scope._sched.wake_up_hint()   # never let an advisory hint deadlock
    join.wait()
    join.raise_errors()
    acc = init
    for p in partials:
        acc = p if acc is _MISSING else reduce_fn(acc, p)
    return acc


# --------------------------------------------------------------- TaskGraph

class _Node:
    __slots__ = ("name", "fn", "deps", "handle")

    def __init__(self, name: str, fn: Callable[..., Any],
                 deps: Tuple[str, ...]):
        self.name = name
        self.fn = fn
        self.deps = deps
        self.handle = TaskHandle(label=name)


class TaskGraph:
    """Dependency-graph builder executed in topological wavefronts.

    ::

        g = TaskGraph()
        a = g.task("a", load)
        b = g.task("b", transform, deps=("a",))     # names or handles
        c = g.task("c", combine, deps=(a, b))
        results = g.run("relic")                    # {"a": ..., "b": ...}
        b.result()                                  # or through the handle

    ``task()`` returns the node's :class:`TaskHandle`; each task function
    receives its dependencies' results positionally, in ``deps`` order.
    Dependencies must already be in the graph when a task is added, so a
    ``TaskGraph`` is acyclic by construction (the legacy dict-of-tuples
    front door, ``repro_torch.tasks.graph.run_wavefronts``, topo-sorts and
    reports cycles before building one of these).

    ``run()`` accepts a :class:`TaskScope` (reused, left open), a registry
    name, or a ``Scheduler`` instance (a scope is created around it for
    the duration). Within a wavefront, all tasks but one are submitted and
    the calling thread runs the last itself; wavefronts are separated by
    joining exactly that wavefront's handles (never a full scope barrier,
    so a borrowed scope's unrelated sibling errors are not misattributed
    to the graph). On failure the aggregate error propagates and every
    never-run task's handle completes with :class:`TaskCancelledError`.
    A graph may be ``run()`` repeatedly (handles are reset per run); runs
    are not reentrant.
    """

    def __init__(self) -> None:
        self._nodes: Dict[str, _Node] = {}

    def task(self, name: str, fn: Callable[..., Any],
             deps: Iterable[Union[str, TaskHandle]] = ()) -> TaskHandle:
        """Add ``name`` running ``fn(*dep_results)``; returns its handle."""
        if name in self._nodes:
            raise ValueError(f"duplicate task {name!r}")
        dep_names: List[str] = []
        for d in deps:
            dep = d.label if isinstance(d, TaskHandle) else d
            if dep not in self._nodes:
                raise ValueError(f"task {name!r} depends on unknown {dep!r}")
            if isinstance(d, TaskHandle) and self._nodes[dep].handle is not d:
                raise ValueError(
                    f"task {name!r}: dependency handle {dep!r} does not "
                    "belong to this graph")
            dep_names.append(dep)
        node = _Node(name, fn, tuple(dep_names))
        self._nodes[name] = node
        return node.handle

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._nodes)

    def handle(self, name: str) -> TaskHandle:
        return self._nodes[name].handle

    def run(self, scope: Union[TaskScope, str, Scheduler] = "relic",
            streaming: bool = False,
            **scope_kwargs: Any) -> Dict[str, Any]:
        """Execute the graph; returns ``{name: result}``.

        ``streaming=False`` (the baseline) runs barriered wavefronts:
        stage N+1 starts only after *all* of stage N joined.
        ``streaming=True`` runs the dataflow executor: each task is
        submitted the moment its own dependencies complete, so items flow
        through ready stages while unrelated upstream tasks are still
        producing — no wavefront barrier on the critical path. Results,
        error aggregation and cancellation semantics are identical
        (pinned by ``tests/test_stream.py``); only the join structure
        differs, which is what the ``stream`` benchmark section A/Bs.
        """
        runner = self._run_streaming if streaming else self._run
        if isinstance(scope, TaskScope):
            if scope_kwargs:
                raise TypeError("scope kwargs only apply when run() builds "
                                "the TaskScope itself")
            return runner(scope)
        with TaskScope(scope, **scope_kwargs) as s:
            return runner(s)

    def as_stream(self, scope: Union[TaskScope, str, Scheduler] = "relic",
                  **scope_kwargs: Any) -> Dict[str, Any]:
        """Alias for ``run(scope, streaming=True)``."""
        return self.run(scope, streaming=True, **scope_kwargs)

    def _run(self, scope: TaskScope) -> Dict[str, Any]:
        for node in self._nodes.values():
            node.handle._reset()
        remaining = dict(self._nodes)
        done: set = set()
        try:
            while remaining:
                wave = [node for node in remaining.values()
                        if all(d in done for d in node.deps)]
                # acyclic by construction => every round makes progress
                for node in wave[:-1]:
                    args = tuple(self._nodes[d].handle.result()
                                 for d in node.deps)
                    scope._submit_into(node.handle, node.fn, args, {})
                last = wave[-1]
                args = tuple(self._nodes[d].handle.result() for d in last.deps)
                scope._run_into(last.handle, last.fn, args, {})
                # Join only this wavefront's own handles (not a full scope
                # barrier): on a borrowed long-lived scope, a barrier would
                # raise — and clear — errors from unrelated sibling tasks,
                # misattributing them to the graph (the same fix
                # parallel_for has).
                scope._wait_handles([node.handle for node in wave])
                for node in wave:
                    done.add(node.name)
                    del remaining[node.name]
        finally:
            for node in remaining.values():
                if not node.handle.done():
                    node.handle._finish(None, TaskCancelledError(
                        f"task {node.name!r} never ran (an upstream "
                        f"dependency failed)"))
        return {name: node.handle.result() for name, node in self._nodes.items()}

    def _run_streaming(self, scope: TaskScope) -> Dict[str, Any]:
        """Dataflow execution: submit each task the moment its own deps
        complete (no wavefront barrier). The calling thread still
        participates — of each newly-ready set it runs one task inline
        (producer-participates, paper §VI) — and between submissions it
        sweeps in-flight handles with the scheduler-free ``_done`` flag,
        pausing on the shared spin cadence. Failure joins exactly the
        graph's own in-flight handles (never a scope barrier), so
        borrowed-scope sibling errors are not misattributed; never-run
        tasks cancel with :class:`TaskCancelledError` like the wavefront
        path."""
        for node in self._nodes.values():
            node.handle._reset()
        waiting = dict(self._nodes)
        inflight: List[_Node] = []
        done: set = set()
        woke = False
        try:
            while waiting or inflight:
                progress = False
                still: List[_Node] = []
                finished: List[_Node] = []
                for node in inflight:
                    (finished if node.handle._done else still).append(node)
                if finished:
                    progress = True
                    inflight = still
                    if any(n.handle._error is not None for n in finished):
                        # Join the graph's whole in-flight set and raise
                        # only its errors (pulled from the scope aggregate
                        # like the wavefront path's per-wave join).
                        scope._wait_handles(
                            [n.handle for n in finished]
                            + [n.handle for n in still])
                    for node in finished:
                        done.add(node.name)
                ready = [node for node in waiting.values()
                         if all(d in done for d in node.deps)]
                if ready:
                    progress = True
                    for node in ready:
                        del waiting[node.name]
                    for node in ready[:-1]:
                        args = tuple(self._nodes[d].handle.result()
                                     for d in node.deps)
                        scope._submit_into(node.handle, node.fn, args, {})
                        inflight.append(node)
                    # Producer-participates: the caller runs one ready task
                    # itself instead of going straight to a poll loop.
                    last = ready[-1]
                    args = tuple(self._nodes[d].handle.result()
                                 for d in last.deps)
                    scope._run_into(last.handle, last.fn, args, {})
                    if last.handle._error is not None:
                        scope._wait_handles(
                            [last.handle] + [n.handle for n in inflight])
                    done.add(last.name)
                if progress:
                    woke = False
                    continue
                # Nothing newly done, nothing ready: in-flight tasks hold
                # the frontier (acyclic => inflight is non-empty here).
                # Un-park a sleeping worker once (advisory hints must never
                # deadlock a join), then *block* on the oldest in-flight
                # handle rather than spin-polling: handles finish FIFO
                # within a lane, and Event.wait hands the GIL to the
                # workers — on few-core hosts a polling driver starves the
                # very tasks it is waiting for. The short timeout re-sweeps
                # the whole frontier so an out-of-order completion on
                # another lane is picked up promptly too.
                if not woke:
                    scope.wake_up_hint()
                    woke = True
                inflight[0].handle._wait(0.0005)
        finally:
            for node in waiting.values():
                if not node.handle.done():
                    node.handle._finish(None, TaskCancelledError(
                        f"task {node.name!r} never ran (an upstream "
                        f"dependency failed)"))
        return {name: node.handle.result() for name, node in self._nodes.items()}
