"""Per-client SPSC ingest: the FastFlow construction applied to admission.

Every queue in the serving subsystem is strictly single-producer /
single-consumer — the same ``repro_torch.core.spsc.SpscRing`` the Relic pair runs
on, composed into a fan-in network instead of replaced by a lock or an MPMC
queue (FastFlow's core claim, PAPERS.md):

    client thread ──SpscRing──▶ scheduler loop      (one ring per client)
    scheduler loop ──lane rings──▶ assistants       (RelicPool, existing)

The 1P1C contract is *enforced*, not just documented: a ``ClientHandle``
pins the first submitting thread's ident and raises ``ServeUsageError`` if
any other thread submits through the same handle (multi-threaded clients
open one handle per thread). The consumer side is single by construction —
only the ``ServeScheduler`` loop drains client rings.

Backpressure is bounded by the ring capacity (``RELIC_SERVE_QUEUE_DEPTH``)
with two admission policies (``RELIC_SERVE_ADMISSION``):

- ``block``  — the client spins (with ``sleep(0)`` yields at the Relic spin
  cadence) until a slot frees; closed-loop clients want this.
- ``reject`` — ``submit`` returns ``None`` immediately and the per-client
  ``rejected`` counter increments; open-loop load generators want this so
  offered load beyond capacity is *measured*, not silently queued.

Registration (``Ingest.open_client``) takes a lock; the submit/drain hot
paths never do.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.relic import _PROBE_EVERY_SPINS, RelicDeadError
from repro_torch.core.spsc import SpscRing
from repro_torch.runtime.config import (
    ServeConfig,
    resolve_serve_config,
    resolve_spin_pause_every,
)
from repro_torch.serve.metrics import now
from repro_torch.serve.request import Request, Response


class ServeUsageError(RuntimeError):
    """Raised on serving-API misuse (wrong-thread submit, closed ingest)."""


class RejectedError(RuntimeError):
    """Raised by ``submit(..., must_admit=True)`` when the ring is full
    under the ``reject`` policy."""


class ClientHandle:
    """One client's private lane into the server: a 1P1C ``SpscRing``.

    Producer: exactly one client thread (ident pinned on first submit).
    Consumer: the scheduler loop (via ``_drain``). The only shared state
    beyond the ring is the advisory parked-flag read used to wake a
    sleeping scheduler — same philosophy as ``Relic.wake_up_hint``.
    """

    def __init__(
        self,
        client_id: str,
        config: ServeConfig,
        wake: Callable[[], None],
        default_deadline_s: Optional[float],
        consumer_alive: Callable[[], bool] = lambda: True,
    ) -> None:
        self.client_id = client_id
        self._ring = SpscRing(config.queue_depth)
        self._admission = config.admission
        self._wake = wake
        self._consumer_alive = consumer_alive
        self._default_deadline_s = default_deadline_s
        self._spin_pause_every = resolve_spin_pause_every()
        self._producer_ident: Optional[int] = None
        self.rejected = 0          # written by the client thread only
        self.submitted = 0
        self._closed = False

    def _check_producer(self) -> None:
        ident = threading.get_ident()
        if self._producer_ident is None:
            self._producer_ident = ident
        elif ident != self._producer_ident:
            raise ServeUsageError(
                f"ClientHandle {self.client_id!r} is single-producer: "
                f"submit() called from thread {ident}, but the handle is "
                f"pinned to thread {self._producer_ident}. Open one handle "
                "per producing thread.")

    def submit(
        self,
        fn: Callable[..., Any],
        *args: Any,
        deadline_s: Optional[float] = None,
        must_admit: bool = False,
        idempotent: bool = False,
    ) -> Optional[Response]:
        """Enqueue one request; returns its ``Response`` future.

        Under the ``reject`` policy a full ring returns ``None`` (or raises
        ``RejectedError`` if ``must_admit``) and counts the rejection.
        Under ``block`` the call spins until a slot frees — a *bounded*
        wait: the spin probes the consumer's liveness at the same cadence
        as the Relic producer slow paths and raises ``RelicDeadError`` if
        the scheduler loop died (otherwise a full ring plus a dead server
        would hang the client forever).
        ``deadline_s`` is seconds-from-now; defaults to the configured
        ``RELIC_SERVE_DEADLINE_MS``. ``idempotent=True`` marks the request
        safe to re-run, opting it into server-side retry.
        """
        self._check_producer()
        if self._closed:
            raise ServeUsageError(
                f"ClientHandle {self.client_id!r} submitted after close")
        arrival = now()
        if deadline_s is None:
            deadline_s = self._default_deadline_s
        req = Request(
            rid=Request.next_rid(),
            client_id=self.client_id,
            fn=fn,
            args=args,
            arrival_t=arrival,
            deadline_t=None if deadline_s is None else arrival + deadline_s,
            idempotent=idempotent,
        )
        resp = Response(req)
        ring = self._ring
        if not ring.push(resp):
            if self._admission == "reject":
                self.rejected += 1
                if must_admit:
                    raise RejectedError(
                        f"client {self.client_id!r} ring full "
                        f"(depth {ring.capacity})")
                return None
            # block: bounded by the consumer making progress *or* dying.
            spins = 0
            pause_every = self._spin_pause_every
            while not ring.push(resp):
                spins += 1
                if spins % pause_every == 0:
                    time.sleep(0)
                if (spins % _PROBE_EVERY_SPINS == 0
                        and not self._consumer_alive()):
                    pending = len(self._ring)
                    raise RelicDeadError(
                        lane=f"serve:{self.client_id}",
                        submitted=self.submitted,
                        completed=self.submitted - pending,
                        lost=pending,
                    )
                self._wake()
        self.submitted += 1
        self._wake()
        return resp

    def close(self) -> None:
        self._closed = True

    # -- consumer side (scheduler loop only) ------------------------------

    def _drain(self, max_items: int) -> List[Response]:
        """Pop up to ``max_items`` pending responses (scheduler loop only)."""
        return self._ring.pop_many(max_items)

    def _pending(self) -> int:
        return len(self._ring)


class Ingest:
    """The fan-in network: all client handles for one scheduler.

    ``open_client`` is the only locked operation; the scheduler loop reads
    ``self._clients`` (a list, appended-to under the lock, never mutated in
    place) without locking — Python list append is atomic and the loop
    tolerates seeing a handle one poll late.
    """

    def __init__(
        self,
        config: Optional[ServeConfig] = None,
        wake: Callable[[], None] = lambda: None,
        consumer_alive: Callable[[], bool] = lambda: True,
    ) -> None:
        self.config = config or resolve_serve_config()
        self._wake = wake
        self._consumer_alive = consumer_alive
        self._default_deadline_s = (
            None if self.config.deadline_ms is None
            else self.config.deadline_ms / 1000.0)
        self._lock = threading.Lock()
        self._clients: List[ClientHandle] = []
        self._by_id: Dict[str, ClientHandle] = {}

    def open_client(self, client_id: Optional[str] = None) -> ClientHandle:
        with self._lock:
            if client_id is None:
                client_id = f"client-{len(self._clients)}"
            if client_id in self._by_id:
                raise ServeUsageError(
                    f"client id {client_id!r} already registered")
            handle = ClientHandle(
                client_id, self.config, self._wake,
                self._default_deadline_s,
                consumer_alive=self._consumer_alive)
            self._by_id[client_id] = handle
            # Publish last: the scheduler iterates self._clients lock-free.
            self._clients.append(handle)
            return handle

    @property
    def clients(self) -> Tuple[ClientHandle, ...]:
        return tuple(self._clients)

    def total_rejected(self) -> int:
        return sum(c.rejected for c in self._clients)

    def pending(self) -> int:
        """Racy total of requests sitting in client rings (observability)."""
        return sum(c._pending() for c in self._clients)

    def poll(self, budget: int) -> List[Response]:
        """Scheduler-loop-only: round-robin drain up to ``budget`` requests
        across client rings (at most a fair share per client per poll, so
        one hot client cannot starve the rest)."""
        clients = self._clients
        if not clients or budget <= 0:
            return []
        out: List[Response] = []
        share = max(1, budget // len(clients))
        for handle in clients:
            if len(out) >= budget:
                break
            out.extend(handle._drain(min(share, budget - len(out))))
        return out

    def close(self) -> None:
        for handle in self._clients:
            handle.close()
