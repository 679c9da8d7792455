"""Request/Response types for the serving subsystem.

``Response`` is a future with the same lazy-``Event`` publication pattern as
``repro_torch.tasks.api.TaskHandle``: the completing thread writes the payload
fields *then* flips ``_done = True`` (the single publication point — CPython
guarantees the preceding writes are visible once the flag read returns
True), and a ``threading.Event`` is only allocated when someone actually
blocks in ``wait()``. A serving loop that polls ``done()`` on thousands of
in-flight responses therefore allocates zero synchronization objects.

Timestamps are ``time.perf_counter()`` seconds (see ``metrics.now``):

- ``arrival_t``   — stamped by the client at ``submit()`` time
- ``admit_t``     — stamped by the scheduler when the request leaves its
  client ring and joins the in-flight batch
- ``first_result_t`` — first streamed item for generator work (TTFT for the
  token-serving demo); equals completion for scalar work
- ``complete_t``  — stamped when the work function returns/raises
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

_rid_counter = itertools.count()

#: Terminal Response statuses.
STATUS_OK = "ok"
STATUS_ERROR = "error"
STATUS_DEADLINE = "deadline_exceeded"
STATUS_CANCELLED = "cancelled"


@dataclass
class Request:
    """One unit of client work: a blocking thunk plus its envelope.

    ``idempotent=True`` declares that re-running ``fn`` is safe; only such
    requests are eligible for server-side retry (task error or lane death
    — see ``repro_torch.serve.retry``). The server cannot infer this, so the
    default is the conservative ``False``: fail fast, never re-run.
    """

    rid: int
    client_id: str
    fn: Callable[..., Any]
    args: Tuple = ()
    arrival_t: float = 0.0
    deadline_t: Optional[float] = None   # absolute perf_counter deadline
    admit_t: Optional[float] = None      # stamped by the scheduler
    idempotent: bool = False             # safe to re-run on failure

    @staticmethod
    def next_rid() -> int:
        return next(_rid_counter)


class Response:
    """Future for one request. Written by the scheduler side, read anywhere.

    ``status`` is one of ``"ok" | "error" | "deadline_exceeded" |
    "cancelled"`` once ``done()`` is True, else ``None``.
    """

    __slots__ = (
        "request", "_done", "status", "value", "error",
        "first_result_t", "complete_t", "_event", "_event_init_lock",
        "attempts", "_retry_pending", "_retry_error", "_retry_at",
    )

    def __init__(self, request: Request) -> None:
        self.request = request
        self._done = False
        self.status: Optional[str] = None
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.first_result_t: Optional[float] = None
        self.complete_t: Optional[float] = None
        self._event: Optional[threading.Event] = None
        self._event_init_lock = threading.Lock()
        # Retry bookkeeping (repro_torch.serve.retry). A retry-eligible failure
        # is never published: _execute stores the error and flips
        # _retry_pending instead of calling _finish, so external waiters
        # keep waiting on the *same* future across attempts — there is no
        # reset race because done() never goes True-then-False. attempts
        # counts executions spent; the loop thread owns these fields.
        self.attempts = 0
        self._retry_pending = False
        self._retry_error: Optional[BaseException] = None
        self._retry_at = 0.0

    # -- completion side (scheduler/assistant threads) --------------------

    def _finish(
        self,
        status: str,
        value: Any = None,
        error: Optional[BaseException] = None,
        complete_t: Optional[float] = None,
    ) -> None:
        """Publish the result. Payload writes precede the ``_done`` flip;
        the flag is the publication point, the Event (if any waiter
        installed one) is only an advisory wake-up."""
        self.status = status
        self.value = value
        self.error = error
        self.complete_t = complete_t
        self._done = True
        event = self._event
        if event is not None:
            event.set()

    # -- consumer side ----------------------------------------------------

    def done(self) -> bool:
        return self._done

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until finished (or timeout). Returns ``done()``."""
        if self._done:
            return True
        if self._event is None:
            with self._event_init_lock:
                if self._event is None:
                    self._event = threading.Event()
        # Re-check *after* the event is visible: if _finish ran before the
        # install it saw no event to set, but it already flipped _done —
        # checking the flag after installing closes the lost-wakeup window
        # (same ordering as TaskHandle._wait).
        if self._done:
            return True
        self._event.wait(timeout)
        return self._done

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for the value; raise the task's error / SLO violation."""
        if not self.wait(timeout):
            raise TimeoutError(
                f"request {self.request.rid} not done within {timeout}s")
        if self.status == STATUS_OK:
            return self.value
        if self.status == STATUS_ERROR:
            assert self.error is not None
            raise self.error
        raise RuntimeError(
            f"request {self.request.rid} finished with status "
            f"{self.status!r}")

    @property
    def latency(self) -> Optional[float]:
        """Arrival-to-complete seconds, once done."""
        if self.complete_t is None:
            return None
        return self.complete_t - self.request.arrival_t

    @property
    def queue_delay(self) -> Optional[float]:
        """Arrival-to-admission seconds, once admitted."""
        if self.request.admit_t is None:
            return None
        return self.request.admit_t - self.request.arrival_t

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = self.status if self._done else "pending"
        return (
            f"Response(rid={self.request.rid}, "
            f"client={self.request.client_id!r}, {state})")
