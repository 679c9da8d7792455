"""Two-lane static ring schedules — the device-scale Relic pattern. The port
of ``src/repro/core/lanes.py``.

The paper's runtime is a *static-role* producer/consumer pair connected by a
bounded queue. Across devices the same shape appears wherever a transfer
feeds a matmul: a P2P send/recv (transfer lane) feeds the tensor cores
(compute lane).

``two_lane_ring`` encodes the schedule once: at ring step ``s`` the
*transfer* for step ``s+1`` is **issued** before the *compute* for step
``s`` consumes its buffer, and waited on only before step ``s+1`` reads it.
With NCCL the P2P runs on its own stream beside the compute, so the two
lanes overlap. The in-flight buffer is the SPSC queue with depth 1; a
depth-2 variant (``two_lane_ring_db``) mirrors the paper's capacity>1 ring.

PyTorch runs eagerly, so the rings are Python loops. A transfer returns a
handle: a zero-argument callable that waits for the move and returns the
buffer it delivered. A transfer whose buffer no step would read is not
issued (the reference's loop computes it and XLA drops it).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

#: A transfer's handle: wait for the move, return the delivered buffer.
Handle = Callable[[], Any]


def two_lane_ring(
    n_steps: int,
    init_buffer: Any,
    init_acc: Any,
    compute: Callable[[int, Any, Any], Any],
    transfer: Callable[[int, Any], Handle],
) -> Any:
    """Run an ``n_steps`` static producer/consumer ring.

    Args:
      n_steps: ring length (e.g. number of ranks along the sharded axis).
      init_buffer: the lane-shared buffer at step 0 (the "queue slot").
      init_acc: accumulator.
      compute: ``(step, buffer, acc) -> acc`` — consumer lane.
      transfer: ``(step, buffer) -> handle`` — producer lane (e.g. a P2P
        send/recv). Issued *before* compute of the same step so the two
        lanes overlap; its handle is waited on before step+1.

    Returns: final accumulator.
    """
    buf, acc = init_buffer, init_acc
    for step in range(n_steps):
        # Producer lane: issue the transfer for the *next* step first.
        nxt = transfer(step, buf) if step + 1 < n_steps else None
        # Consumer lane: use the current buffer.
        acc = compute(step, buf, acc)
        if nxt is not None:
            buf = nxt()
    return acc


def two_lane_ring_db(
    n_steps: int,
    init_buffers: Tuple[Any, Any],
    init_acc: Any,
    compute: Callable[[int, Any, Any], Any],
    transfer: Callable[[int, Any], Handle],
) -> Any:
    """Depth-2 (double-buffered) variant: transfer writes slot ``s+2``.

    Matches the paper's capacity>1 SPSC ring — the producer may run up to two
    steps ahead, which tolerates one full step of transfer latency jitter.
    """
    cur, ahead = init_buffers
    acc = init_acc
    for step in range(n_steps):
        # produce for step s+2 (no step reads what steps n-2, n-1 produce)
        nxt = transfer(step, ahead) if step + 2 < n_steps else None
        acc = compute(step, cur, acc)
        cur, ahead = ahead, (nxt() if nxt is not None else None)
    return acc
