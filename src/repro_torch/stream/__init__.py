"""Streaming executor: compose SPSC lanes into pipelines and farms.

The paper's Relic runtime is one SPSC producer/consumer pair; FastFlow
(Aldinucci et al., 2009) shows exactly that primitive composes into
arbitrary streaming networks — pipelines and farms — without ever adding
a lock or an MPMC queue. This package is that composition layer for the
repro codebase:

* :class:`Stage` — one assistant looping fn over an input/output ring pair
* :class:`Pipeline` — linear driver → stages → driver network
* :class:`Farm` — emitter → N workers → collector, as one pipeline node
* :data:`STOP`, :class:`StreamFailure`, :class:`StreamError` — in-band
  end-of-stream and failure flow

Built on it (PR 9): ``TaskGraph.run(streaming=True)``,
``PrefetchPipeline`` (produce → transform as a 2-stage pipeline, its
``_push_lock`` deleted), ``CheckpointManager`` (overlapped serialize →
publish stages), and ``Workload.streamed()``. See docs/streaming.md.
"""

from repro_torch.stream.farm import Farm, WorkerFailure
from repro_torch.stream.pipeline import Pipeline
from repro_torch.stream.stage import (STOP, Stage, StageFailedError, StreamError,
                                StreamFailure, StreamUsageError, worker_alive)

__all__ = [
    "STOP",
    "Stage",
    "StageFailedError",
    "Pipeline",
    "Farm",
    "WorkerFailure",
    "StreamError",
    "StreamFailure",
    "StreamUsageError",
    "worker_alive",
]
