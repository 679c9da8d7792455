"""Closed-loop and open-loop (Poisson) load generators.

Two canonical load models (see docs/serving.md):

**Closed loop** — N clients, each submit → wait → repeat. Offered load
adapts to service rate, so it measures best-case latency and saturation
throughput; it cannot expose queueing collapse. Uses ``block`` admission.

**Open loop** — arrivals follow a schedule *independent* of completions
(here: Poisson, i.e. exponential inter-arrival gaps), the model that
surfaces tail latency under overload. Uses ``reject`` admission so offered
load beyond capacity is *measured* (rejected counter) rather than silently
deferred — the open-loop-waiting pitfall.

Schedules are generated from a seeded ``numpy`` Generator: same seed ⇒
byte-identical arrival schedule (pinned by tests), so a latency-vs-load
curve is reproducible run to run.

Each client thread owns exactly one ``ClientHandle`` — the 1P1C contract.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.request import Response
from repro_torch.serve.scheduler import ServeScheduler


def poisson_arrivals(
    rate_rps: float, n: int, seed: int = 0
) -> np.ndarray:
    """Absolute arrival offsets (seconds from t0) for a Poisson process of
    ``rate_rps`` requests/second. Deterministic per seed."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / rate_rps, size=n)
    return np.cumsum(gaps)


@dataclass
class LoadResult:
    """What one load-generation run produced (responses + offered load)."""

    responses: List[Response] = field(default_factory=list)
    offered: int = 0
    rejected: int = 0
    wall_s: float = 0.0

    @property
    def completed(self) -> List[Response]:
        return [r for r in self.responses if r.done()]


def run_closed_loop(
    server: ServeScheduler,
    work: Callable[[], Tuple[Callable[..., Any], Tuple]],
    clients: int = 2,
    requests_per_client: int = 16,
    deadline_s: Optional[float] = None,
) -> LoadResult:
    """N closed-loop clients: submit → wait → repeat. ``work()`` is called
    per request (on the client thread) and returns the ``(fn, args)`` to
    submit — a factory, so generators/closures aren't shared across
    threads."""
    result = LoadResult()
    lock = threading.Lock()   # collects responses; never on the submit path
    t0 = time.perf_counter()

    def client_body(idx: int) -> None:
        handle = server.open_client(f"closed-{idx}")
        mine: List[Response] = []
        for _ in range(requests_per_client):
            fn, args = work()
            resp = handle.submit(fn, *args, deadline_s=deadline_s)
            assert resp is not None  # closed loop uses block admission
            resp.wait()
            mine.append(resp)
        with lock:
            result.responses.extend(mine)

    threads = [
        threading.Thread(target=client_body, args=(i,), daemon=True)
        for i in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    result.offered = clients * requests_per_client
    result.wall_s = time.perf_counter() - t0
    return result


def run_open_loop(
    server: ServeScheduler,
    work: Callable[[], Tuple[Callable[..., Any], Tuple]],
    rate_rps: float,
    n_requests: int,
    seed: int = 0,
    deadline_s: Optional[float] = None,
    wait_for_all: bool = True,
) -> LoadResult:
    """One open-loop client submitting on a seeded Poisson schedule.

    The submit thread sleeps to each absolute arrival offset and fires
    regardless of completions. A full ring rejects (counted), it does not
    block — blocking would silently convert the open loop into a closed
    one and hide the overload it exists to measure.
    """
    schedule = poisson_arrivals(rate_rps, n_requests, seed)
    result = LoadResult()
    handle = server.open_client(f"open-{seed}")
    t0 = time.perf_counter()
    for offset in schedule:
        sleep_for = t0 + float(offset) - time.perf_counter()
        if sleep_for > 0:
            time.sleep(sleep_for)
        fn, args = work()
        resp = handle.submit(fn, *args, deadline_s=deadline_s)
        result.offered += 1
        if resp is None:
            continue
        result.responses.append(resp)
    if wait_for_all:
        for resp in result.responses:
            resp.wait()
    result.rejected = handle.rejected
    result.wall_s = time.perf_counter() - t0
    return result
