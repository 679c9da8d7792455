"""Bounded single-producer single-consumer ring queue (paper §VI-A).

The paper uses Boost.Lockfree's SPSC queue with capacity 128. This is the
CPython analogue: a preallocated ring with two monotonically increasing
counters. Only the producer writes ``_tail``; only the consumer writes
``_head``. Under CPython, aligned int stores/loads are atomic (protected by
the interpreter), so the fast path takes no lock — structurally identical to
the Lamport SPSC queue the paper builds on [61].

Two FastFlow-style optimizations (Aldinucci et al., 2009) keep the hot path
allocation- and contention-slim:

* **Cached indexes.** The producer keeps a private snapshot of the
  consumer's ``_head`` and refreshes it only when the ring *appears* full
  against the snapshot (symmetrically, the consumer's single-item ``pop``
  caches ``_tail`` and refreshes only on apparent-empty). On hardware this
  eliminates the cache-line ping-pong of reading the other side's counter
  every operation; under CPython it keeps the per-item path free of
  cross-thread reads, and the refresh-then-recheck makes push/pop exact
  whenever the snapshot goes stale — single-threaded callers observe
  identical semantics to the uncached ring.
* **Batch operations.** ``push_many``/``pop_many`` move a whole burst with
  a single counter publication, so the partner observes (and pays for) one
  update per burst instead of one per item. The batch ops refresh their
  snapshot whenever it cannot satisfy the request — for an unbounded
  ``pop_many`` that is every call — i.e. they pay one cross-thread read
  per *burst*, amortized over the items it moves, rather than relying on
  the stale snapshot (which would return partial drains).

The queue is intentionally *not* multi-producer safe: Relic forbids the
assistant thread from submitting tasks (no recursive spawn, paper §VI-A), so a
single producer is an invariant, not a limitation.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

DEFAULT_CAPACITY = 128  # paper: "We set a capacity of the queue to 128 entries."


class SpscRing:
    """Lamport-style bounded SPSC ring buffer with cached indexes.

    push/pop never block; they return False/None when full/empty so callers
    control their own waiting policy (busy-wait in Relic, paper §VI-B).
    """

    __slots__ = ("_buf", "_capacity", "_head", "_tail",
                 "_cached_head", "_cached_tail")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._buf: list[Any] = [None] * capacity
        self._head = 0  # next slot to pop  (written by consumer only)
        self._tail = 0  # next slot to push (written by producer only)
        self._cached_head = 0  # producer's snapshot of _head
        self._cached_tail = 0  # consumer's snapshot of _tail

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        # Racy but monotonic-safe estimate; exact when called from either end.
        # A third (observer) thread — e.g. RelicPool's least-loaded lane
        # picker — can read a fresh _head against a stale _tail and compute
        # a negative length; clamp so load signals and stats readers never
        # see one.
        d = self._tail - self._head
        return d if d > 0 else 0

    def empty(self) -> bool:
        return self._tail == self._head

    def full(self) -> bool:
        return self._tail - self._head >= self._capacity

    def free_slots(self) -> int:
        """Producer-side free-slot count: a *lower bound* that a subsequent
        ``push_many`` of at most this many items is guaranteed to satisfy
        in full. Reads ``_head`` directly (one cross-thread read — this is
        a slow-path planning call, not the cached hot path); a stale read
        only undercounts pops, so the bound never overpromises. RelicPool's
        re-striping uses it to size a window that must not partially push."""
        free = self._capacity - (self._tail - self._head)
        return free if free > 0 else 0

    def push(self, item: Any) -> bool:
        """Producer side. Returns False if the ring is full."""
        tail = self._tail
        if tail - self._cached_head >= self._capacity:
            # Apparently full against the snapshot: refresh once (the only
            # cross-thread read) and recheck. Exact after the refresh.
            self._cached_head = self._head
            if tail - self._cached_head >= self._capacity:
                return False
        self._buf[tail % self._capacity] = item
        # Publication: the tail increment makes the slot visible. In CPython
        # the GIL orders the buffer write before the counter write.
        self._tail = tail + 1
        return True

    def push2(self, a: Any, b: Any) -> bool:
        """Producer side: push two items with one ``_tail`` publication and
        no container allocation (the degenerate batch). Returns False —
        pushing neither — unless both fit. Relic's task protocol stripes
        ``fn, args`` pairs through this, so a task submit allocates nothing
        beyond what the call protocol already built."""
        tail = self._tail
        if tail + 2 - self._cached_head > self._capacity:
            self._cached_head = self._head
            if tail + 2 - self._cached_head > self._capacity:
                return False
        capacity = self._capacity
        buf = self._buf
        idx = tail % capacity
        buf[idx] = a
        idx += 1
        buf[idx if idx < capacity else 0] = b
        self._tail = tail + 2
        return True

    def push_many(self, items: Sequence[Any], start: int = 0,
                  stop: Optional[int] = None) -> int:
        """Producer side: push as many of ``items[start:stop]`` as fit, in
        order, with a single ``_tail`` publication. Returns the number
        pushed (0 when full). Callers loop on the remainder under their own
        wait policy — advancing ``start`` instead of slicing, so retrying a
        large burst against a full ring never copies the tail. ``stop``
        bounds the window without slicing either: RelicPool pushes each
        lane's shard of one shared flattened burst this way."""
        tail = self._tail
        capacity = self._capacity
        n = (len(items) if stop is None else stop) - start
        if n <= 0:
            return 0        # an exhausted/overshot offset must not move _tail
        free = capacity - (tail - self._cached_head)
        if free < n:
            self._cached_head = self._head
            free = capacity - (tail - self._cached_head)
            if free <= 0:
                return 0
            if free < n:
                n = free
        buf = self._buf
        for i in range(n):
            buf[(tail + i) % capacity] = items[start + i]
        self._tail = tail + n
        return n

    def pop(self) -> Optional[Any]:
        """Consumer side. Returns None if the ring is empty."""
        head = self._head
        if self._cached_tail == head:
            self._cached_tail = self._tail
            if self._cached_tail == head:
                return None
        idx = head % self._capacity
        item = self._buf[idx]
        self._buf[idx] = None  # drop reference early (keeps GC pressure flat)
        self._head = head + 1
        return item

    def pop_many(self, max_items: Optional[int] = None) -> List[Any]:
        """Consumer side: pop every available item (up to ``max_items``), in
        order, with a single ``_head`` publication. Returns a possibly-empty
        list — the burst the consumer drains before re-checking hints."""
        if max_items is not None and max_items <= 0:
            return []       # a non-positive budget must not rewind _head
        head = self._head
        avail = self._cached_tail - head
        if max_items is None or avail < max_items:
            # The snapshot cannot satisfy the request: refresh (the one
            # cross-thread read this burst pays) and recheck — so a
            # same-thread caller always sees every published item.
            self._cached_tail = self._tail
            avail = self._cached_tail - head
            if avail <= 0:
                return []
        if max_items is not None and avail > max_items:
            avail = max_items
        buf = self._buf
        capacity = self._capacity
        out = [None] * avail
        for i in range(avail):
            idx = (head + i) % capacity
            out[i] = buf[idx]
            buf[idx] = None
        self._head = head + avail
        return out
