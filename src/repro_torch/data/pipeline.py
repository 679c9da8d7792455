"""Data pipeline with a Relic-prefetched SPSC batch queue.

The host-side instance of the paper's pattern (docs/schedulers.md): the **assistant
thread produces** batches (synthetic generation / memmap reads / host->device
transfer release the GIL) while the **main thread consumes** them in the
train loop. `wake_up_hint()` is issued when the loop starts, `sleep_hint()`
between epochs/evals — the paper's explicit control points.

Determinism/restart: batch `i` is a pure function of (seed, i, shard), so
resuming from step `i` after a failure replays the exact stream; no iterator
state needs checkpointing beyond the step counter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.core.schedulers import Scheduler
from repro_torch.stream import Pipeline, Stage, StreamFailure


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    shard: int = 0          # this host's index
    num_shards: int = 1
    prefetch: int = 8       # SPSC queue depth for prefetched batches


class SyntheticLM:
    """Seeded synthetic token stream (zipf-ish marginals so losses move)."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        probs = 1.0 / np.arange(1, dc.vocab_size + 1) ** 1.1
        self._probs = probs / probs.sum()

    def batch(self, index: int) -> dict:
        dc = self.dc
        rng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, index, dc.shard]))
        b = dc.global_batch // dc.num_shards
        toks = rng.choice(dc.vocab_size, size=(b, dc.seq_len + 1),
                          p=self._probs).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((b, dc.seq_len), np.float32),
        }


class MemmapLM:
    """Flat token file (np.memmap) chunked into fixed-length sequences."""

    def __init__(self, dc: DataConfig, path: str, dtype=np.int32):
        self.dc = dc
        self._data = np.memmap(path, dtype=dtype, mode="r")
        self._n_seqs = (len(self._data) - 1) // dc.seq_len

    def batch(self, index: int) -> dict:
        dc = self.dc
        rng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, index, dc.shard]))
        b = dc.global_batch // dc.num_shards
        starts = rng.integers(0, self._n_seqs, size=b) * dc.seq_len
        toks = np.stack([np.asarray(self._data[s:s + dc.seq_len + 1])
                         for s in starts]).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((b, dc.seq_len), np.float32),
        }


class PrefetchPipeline:
    """Prefetched batch stream, built as a 2-stage streaming pipeline.

    Since PR 9 this is a thin consumer of :class:`repro_torch.stream.Pipeline`:
    batch *indices* flow in, batches flow out, through a ``produce`` stage
    (``source.batch(i)``) and — when a ``transform`` is given — a second
    ``transform`` stage whose work overlaps production of the next batch.
    Every ring in the network is strictly 1P1C by construction, which is
    why the old ``_push_lock`` no longer exists: that lock only served to
    serialize multi-worker pool substrates racing on one hand-rolled ring,
    a shape the per-stage 1P1C composition makes structurally impossible.

    Substrates: a registry name gives each stage its own assistant
    (``"serial"`` degrades to synchronous on-demand production, no worker
    thread); a ``Scheduler`` *instance* fuses produce+transform into one
    stage hosted on it. Batches are delivered strictly in index order on
    *every* substrate — the linear pipeline is FIFO end-to-end, so no
    index stash is needed either.

    Supervision (PR 8 discipline, closing the PR 8 gap in this file):
    every wait — consumer pops in ``next_batch()``, producer pushes on a
    full ring — is bounded, probing the neighbouring thread's liveness
    every ``_PROBE_EVERY_SPINS`` spins and raising
    :class:`repro_torch.core.relic.RelicDeadError` with fed/drained diagnostics
    instead of spinning on a stream that can never advance
    (``RELIC_SUPERVISE=0`` opts out, same switch as the substrate).

    Failures stay in-stream: a batch whose production (or transform)
    raised arrives as a marker and ``next_batch()`` raises
    ``RuntimeError("batch {i} production failed")`` chaining the original
    error — the contract ``tests/test_schedulers_conformance.py`` pins.
    """

    def __init__(self, source, dc: DataConfig, start_index: int = 0,
                 transform: Optional[Callable[[dict], dict]] = None,
                 scheduler: "str | Scheduler" = "relic"):
        self.source = source
        self.dc = dc
        self._next_submit = start_index
        self._next_consume = start_index
        self._transform = transform
        self._scheduler_spec = scheduler
        self._pipe: Optional[Pipeline] = None
        self._started = False
        self._stopping = False

    def _produce(self, index: int) -> dict:
        return self.source.batch(index)

    # -- main-thread API ----------------------------------------------------
    def start(self) -> "PrefetchPipeline":
        if not self._started:
            if self._stopping:
                # Substrates are one-shot; determinism makes restart cheap
                # anyway (batch i is a pure function of (seed, i, shard)).
                raise RuntimeError(
                    "PrefetchPipeline cannot restart after stop(); build a "
                    "new pipeline with start_index at the resume point")
            spec = self._scheduler_spec
            cap = self.dc.prefetch
            if isinstance(spec, str) and self._transform is not None:
                # Two stages, two assistants: transform overlaps produce.
                nodes = [
                    Stage(self._produce, name="produce", capacity=cap,
                          substrate=spec),
                    Stage(self._transform, name="transform", capacity=cap,
                          substrate=spec),
                ]
            elif isinstance(spec, str):
                nodes = [Stage(self._produce, name="produce", capacity=cap,
                               substrate=spec)]
            else:
                # One Scheduler instance hosts one loop: fuse the stages.
                def produce_transform(index: int) -> dict:
                    batch = self.source.batch(index)
                    if self._transform is not None:
                        batch = self._transform(batch)
                    return batch
                nodes = [Stage(produce_transform, name="produce",
                               capacity=cap, substrate=spec)]
            self._pipe = Pipeline(nodes, capacity=cap).start()
            self._pipe.resume()
            # The consumer-facing batch ring (depth-pinned by tests): the
            # streaming network's sink. In inline (serial) mode outputs
            # buffer in a deque instead and the ring stays empty.
            self._ring = self._pipe.sink_ring
            # Prime the window: keep `prefetch` indices in flight.
            for _ in range(cap):
                self._pipe.put(self._next_submit)
                self._next_submit += 1
            self._started = True
        return self

    def next_batch(self) -> dict:
        assert self._started, "call start() first"
        # Bounded wait: get_raw probes the producing stage's liveness and
        # raises RelicDeadError if its assistant died mid-stream.
        batch = self._pipe.get_raw()
        index = self._next_consume
        self._next_consume += 1
        # keep the assistant one window ahead
        self._pipe.put(self._next_submit)
        self._next_submit += 1
        if type(batch) is StreamFailure:
            raise RuntimeError(
                f"batch {index} production failed") from batch.error
        return batch

    def pause(self) -> None:
        """Between parallelizable sections (paper's sleep_hint)."""
        if self._pipe is not None:
            self._pipe.pause()

    def resume(self) -> None:
        if self._pipe is not None:
            self._pipe.resume()

    def stop(self) -> None:
        if self._started:
            self._stopping = True
            self._pipe.close()   # flows STOP, drains leftovers, joins
            self._started = False

    def __iter__(self) -> Iterator[dict]:
        self.start()
        while True:
            yield self.next_batch()
