"""One CUDA stream per lane: how a task closure waits for its own work.

The JAX package's task closures end in ``jax.block_until_ready``, which
waits for one result and nothing else. The port's counterpart: every thread
that runs tasks (the producer, each Relic assistant, each pool lane) issues
its work on a stream of its own, records an event behind it and waits on
that event. It never calls ``torch.cuda.synchronize()``, which would wait
for every lane's work, so the two instances of a paired run can overlap on
the card. On the CPU the work is done when the call returns.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

_LANE = threading.local()


def lane_stream(device: torch.device) -> "torch.cuda.Stream":
    """The calling thread's own stream on ``device``, made at first use."""
    streams = getattr(_LANE, "streams", None)
    if streams is None:
        streams = _LANE.streams = {}
    stream = streams.get(device.index)
    if stream is None:
        stream = streams[device.index] = torch.cuda.Stream(device)
    return stream


def run_blocking(fn: Callable[[], Any], device: torch.device) -> Any:
    """``fn()`` issued on this thread's stream, returned once its work on the
    card is done (an event on that stream, not a device-wide wait)."""
    if device.type != "cuda":
        return fn()
    stream = lane_stream(device)
    with torch.cuda.stream(stream):
        out = fn()
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out
