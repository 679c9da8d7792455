"""The ``Workload`` protocol: the paper's kernels as first-class workloads.

A workload is *n* identical instances of one fine-grained kernel (the paper
generates two identical graphs / two buffer copies, §IV) plus an oracle.
Every workload exposes the same three execution variants, all driven
through the :mod:`repro_torch.tasks.api` façade:

  * ``serial()`` — every instance inline on the calling thread (the
    paper's baseline; also what warms the caches).
  * ``paired(scope)`` — the paper's two-instance offload (§V/§VII): the
    back half of the instances is submitted to the scope's substrate, the
    producer runs the front half itself, then joins the handles.
  * ``chunked(scope, grain)`` — worksharing loop execution (Maroñas et
    al., 2020): one ``parallel_for`` over the instances, chunked by
    ``grain`` instances per task.

There is additionally ``streamed(substrate)`` — pipelined
execution over :mod:`repro_torch.stream`, where the workload's stream items
flow through its ``_stream_stages()`` decomposition (instance tasks by
default; stencil time-steps / jsondoc byte chunks for the workloads that
override it). It is deliberately *not* part of ``VARIANTS``: the three
variants share one task list, while ``streamed`` reshapes the work, so
benchmarks compare it explicitly rather than implicitly.

Instance task closures **block until the result is ready**, so every
variant times compute, not async dispatch. Where the reference ends each
thunk in ``jax.block_until_ready``, the port issues it on the calling
thread's own CUDA stream and waits on an event behind it
(:func:`repro_torch.tasks.streams.run_blocking`), never on
``torch.cuda.synchronize()``: the producer and the assistant are two lanes
with two streams, so the two instances of ``paired`` can overlap on the
card. The raw non-blocking dispatch closures remain available as
``dispatches``.

Results are checked two ways by :meth:`Workload.check`: all instances
must agree with instance 0 (they run identical inputs), and instance 0
must pass the subclass's independent oracle (``check_one``, NumPy/stdlib
reference implementations — never the kernel under test).

Every workload also carries a *skewed cost* dimension (``skew=alpha``,
``skew_seed``): per-instance power-law repeat counts that model the
irregular task costs where static lane striping loses to dynamic load
balancing (the ``skew`` benchmark section / RelicPool rebalancing). A
skewed run returns the same results and passes the same oracle — only
the cost profile changes.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.tasks.api import TaskScope, parallel_for
from repro_torch.tasks.streams import run_blocking

__all__ = [
    "Workload",
    "WorkloadOracleError",
    "VARIANTS",
    "results_agree",
    "register_workload",
    "available_workloads",
    "make_workload",
    "split_instances",
]

# The uniform execution shapes every workload exposes (benchmarks and the
# conformance tests iterate this, not hand-rolled lists).
VARIANTS = ("serial", "paired", "chunked")


class WorkloadOracleError(AssertionError):
    """A workload result failed its oracle (or instances disagreed)."""


# --------------------------------------------------------------------- registry

_REGISTRY = {}


def register_workload(cls):
    """Class decorator registering a workload under ``cls.name`` (the same
    flat name -> factory shape as ``repro_torch.core.schedulers``)."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty name")
    _REGISTRY[cls.name] = cls
    return cls


def available_workloads() -> List[str]:
    """Registered workload names, stable (sorted) order."""
    return sorted(_REGISTRY)


def make_workload(name: str, **kwargs: Any) -> "Workload":
    """Instantiate a workload by name (inputs built lazily)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r}; available: {available_workloads()}"
        ) from None
    return factory(**kwargs)


def to_numpy(x: Any) -> np.ndarray:
    """A result leaf on the host: a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(tree: Any) -> List[np.ndarray]:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [to_numpy(tree)]


def split_instances(stacked: Any, n: int) -> List[Any]:
    """The fused variant's result (every leaf stacked on a leading instance
    axis) as the per-instance result list the other variants return."""
    def pick(tree, i):
        if isinstance(tree, (list, tuple)):
            return type(tree)(pick(t, i) for t in tree)
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]
    return [pick(stacked, i) for i in range(n)]


def results_agree(a: Any, b: Any, *, rtol: float = 0.0, atol: float = 0.0) -> bool:
    """True when two instance results (nested tuples, lists and dicts of
    tensors or arrays) match."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    return all(x.shape == y.shape and np.allclose(x, y, rtol=rtol, atol=atol)
               for x, y in zip(la, lb))


class Workload:
    """Base class: subclasses set ``name``, implement ``_input()`` (the
    shared base input array) + ``_kernel(x)`` (the single-instance kernel
    call), and ``check_one(result)`` (the oracle for one instance's
    result). The base class derives everything else: ``_build()`` gives
    each instance its **own copy** of the input on ``device`` (the paper's
    two identical graphs / buffer copies — paired tasks never alias device
    memory) and ``_build_fused()`` stacks the copies into one batched
    kernel call (every kernel takes leading batch dimensions). Workloads
    whose instances are not copy-of-one-input can override
    ``_build()``/``_build_fused()`` directly. ``device`` is the card unless
    the caller passes ``device="cpu"``.

    ``_build()`` returns ``n_instances`` zero-argument callables, each
    dispatching the kernel on that instance's own input copy and returning
    the (possibly still in-flight) result; the base class derives the
    blocking ``tasks`` from them. Building is lazy and cached — the first
    access warms every instance.
    """

    name: str = ""
    default_instances: int = 2

    def __init__(self, n_instances: Optional[int] = None, *,
                 skew: Optional[float] = None, skew_seed: int = 0,
                 device: Any = "cuda"):
        n = self.default_instances if n_instances is None else n_instances
        if n < 2:
            raise ValueError(
                f"workload {self.name!r} needs >= 2 instances for the "
                f"paired variant, got {n}")
        self.n_instances = n
        self.device = resolve_device(device)
        # Skewed task-cost dimension: with ``skew=alpha`` each
        # instance's blocking task repeats its kernel ``repeats[i]`` times,
        # where the repeat counts follow a Zipf-by-rank power law — the
        # rank-r instance costs ~ r**-alpha of the heaviest, scaled so the
        # heaviest repeats ``n`` times and every instance repeats at least
        # once. Which *position* gets which rank is a seeded shuffle
        # (``skew_seed``), so the cost profile is deterministic per seed
        # but not correlated with submission order. Results are unchanged
        # (the kernel is idempotent on its own input copy), so the oracle
        # and cross-instance agreement checks apply as-is — a skewed run
        # is still fully checked. Subclasses never override __init__, so
        # every registered workload gains the dimension uniformly.
        self.skew = skew
        self.skew_seed = skew_seed
        if skew is None:
            self.repeats: List[int] = [1] * n
        else:
            if not (skew > 0):
                raise ValueError(f"skew must be a positive exponent, got {skew}")
            ranks = np.arange(1, n + 1, dtype=np.float64)
            reps = np.maximum(1, np.rint(n / ranks ** skew)).astype(np.int64)
            np.random.default_rng(skew_seed).shuffle(reps)
            self.repeats = [int(r) for r in reps]
        self._dispatches: Optional[List[Callable[[], Any]]] = None
        self._tasks: Optional[List[Callable[[], Any]]] = None
        self._fused: Optional[Callable[[], Any]] = None

    # -- subclass surface --------------------------------------------------
    def _input(self) -> Any:
        """The shared base input (a numpy array or a CPU tensor) each
        instance gets a copy of."""
        raise NotImplementedError

    def _kernel(self, x: Any) -> Any:
        """Dispatch the kernel on one instance's input; may return an
        in-flight result (the base class blocks in ``tasks``)."""
        raise NotImplementedError

    def _copy(self) -> torch.Tensor:
        """A private copy of the base input on this workload's device."""
        return torch.as_tensor(self._input()).to(self.device, copy=True)

    def _block(self, fn: Callable[[], Any]) -> Any:
        """``fn()``, returned once its work is done (the calling thread's
        stream and event; the reference's ``jax.block_until_ready``)."""
        return run_blocking(fn, self.device)

    def _build(self) -> Sequence[Callable[[], Any]]:
        copies = [self._copy() for _ in range(self.n_instances)]
        return [functools.partial(self._kernel, x) for x in copies]

    def _build_fused(self) -> Optional[Callable[[], Any]]:
        """One batched call covering every instance (the reference's
        ``jit(vmap(kernel))``): the kernel on the stacked copies. Return
        None when unsupported."""
        stacked = torch.stack([self._copy() for _ in range(self.n_instances)])
        return functools.partial(self._kernel, stacked)

    def check_one(self, result: Any) -> None:
        raise NotImplementedError

    # -- lazy build --------------------------------------------------------
    @property
    def dispatches(self) -> List[Callable[[], Any]]:
        """Raw non-blocking dispatch thunks, one per instance."""
        if self._dispatches is None:
            built = list(self._build())
            if len(built) != self.n_instances:
                raise RuntimeError(
                    f"{type(self).__name__}._build() returned {len(built)} "
                    f"thunks for {self.n_instances} instances")
            self._dispatches = built
            if self.device.type == "cuda":   # the copies, made on this stream
                torch.cuda.current_stream(self.device).synchronize()
            for d in built:                  # warm every instance
                self._block(d)
        return self._dispatches

    @property
    def tasks(self) -> List[Callable[[], Any]]:
        """Blocking task closures: ``dispatch`` on the calling thread's
        stream + a wait on its event, repeated ``repeats[i]`` times under a skewed cost profile (the
        result is the last repeat's — identical to the first, since each
        dispatch reruns the same kernel on the instance's own input)."""
        if self._tasks is None:
            def blocking(dispatch, reps):
                if reps == 1:
                    def task():
                        return self._block(dispatch)
                else:
                    def task():
                        for _ in range(reps - 1):
                            self._block(dispatch)
                        return self._block(dispatch)
                task.__name__ = f"{self.name}-instance-x{reps}"
                return task

            self._tasks = [blocking(d, r)
                           for d, r in zip(self.dispatches, self.repeats)]
        return self._tasks

    def fused_task(self) -> Callable[[], Any]:
        """Blocking thunk for the fused all-instances batched call; its
        result stacks the instances on a leading axis (``split_instances``).
        Note: the fused variant ignores ``skew`` — one batched call has no
        per-instance cost knob; it exists to benchmark the uniform case."""
        if self._fused is None:
            fused = self._build_fused()
            if fused is None:
                raise NotImplementedError(
                    f"workload {self.name!r} has no fused variant")

            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

            def task():
                return self._block(fused)
            task.__name__ = f"{self.name}-fused"
            self._fused = task
        return self._fused

    # -- streaming surface ---------------------------------------------------
    def _stream_stages(self, stages: Optional[int] = None):
        """``(items, stage_fns)`` for :meth:`streamed`. Base default: the
        instance indices flow through one stage running the instance's
        blocking task (so ``skew`` repeats are honored). Subclasses with a
        natural pipeline decomposition (stencil time-steps, jsondoc byte
        chunks) override this — those decompositions replace the per-task
        skew knob with real per-stage structure, so they ignore ``skew``
        like the fused variant does."""
        if stages not in (None, 1):
            raise ValueError(
                f"workload {self.name!r} has a single-stage stream; "
                f"got stages={stages}")
        tasks = self.tasks

        def run_instance(i: int) -> Any:
            return tasks[i]()

        return list(range(self.n_instances)), [run_instance]

    def _stream_collect(self, outputs: List[Any]) -> List[Any]:
        """Fold the pipeline's output items into the per-instance result
        list :meth:`check` expects (identity by default)."""
        return outputs

    def streamed(self, substrate: Any = "relic", *,
                 stages: Optional[int] = None,
                 capacity: Optional[int] = None) -> List[Any]:
        """Pipelined execution over the streaming executor: the workload's
        stream items flow through its stage functions composed as a
        :class:`repro_torch.stream.Pipeline` (each stage its own assistant for a
        registry-name ``substrate``; fused onto a single ``Scheduler``
        instance; fully inline under ``"serial"``). Returns the same
        per-instance result list as every other variant — oracle-checked
        with :meth:`check` like the rest."""
        from repro_torch.stream import Pipeline
        items, fns = self._stream_stages(stages)
        cap = capacity if capacity is not None else max(4, min(32, len(items)))
        with Pipeline(list(fns), substrate=substrate, capacity=cap) as pipe:
            outputs = pipe.run(items)
        return self._stream_collect(outputs)

    # -- the three execution variants --------------------------------------
    def serial(self) -> List[Any]:
        """Every instance inline, in order (the paper's serial baseline)."""
        return [t() for t in self.tasks]

    def paired(self, scope: TaskScope) -> List[Any]:
        """The paper's paired offload: submit the back half of the
        instances to the scope's substrate, run the front half on the
        calling thread (producer-participates, §VI), join the handles.
        Results come back in instance order."""
        tasks = self.tasks
        half = (len(tasks) + 1) // 2          # producer's share, never empty
        handles = [scope.submit(t) for t in tasks[half:]]
        mine = [t() for t in tasks[:half]]
        if not all(h.done() for h in handles):
            # Advisory hints must never deadlock a join (the SPI rule):
            # un-park a sleeping worker before blocking on the handles.
            scope.wake_up_hint()
        return mine + [h.result() for h in handles]

    def chunked(self, scope: TaskScope, grain: int = 1) -> List[Any]:
        """Worksharing over the instances: one ``parallel_for``, ``grain``
        instances per task (the calling thread runs the final chunk)."""
        tasks = self.tasks
        out: List[Any] = [None] * len(tasks)

        def body(i: int) -> None:
            out[i] = tasks[i]()

        parallel_for(scope, len(tasks), body, grain=grain)
        return out

    # -- oracle ------------------------------------------------------------
    # Float tolerance for cross-instance agreement: instances run identical
    # inputs through the same kernel, so exact equality is the
    # default; subclasses with nondeterministic reductions may relax it.
    agree_rtol: float = 0.0
    agree_atol: float = 0.0

    def check(self, results: Sequence[Any]) -> None:
        """Validate one variant's result list: instance count, cross-instance
        agreement, then the subclass oracle on instance 0. Raises
        :class:`WorkloadOracleError` (an ``AssertionError``) on mismatch."""
        if len(results) != self.n_instances:
            raise WorkloadOracleError(
                f"{self.name}: expected {self.n_instances} instance results, "
                f"got {len(results)}")
        for i, r in enumerate(results[1:], start=1):
            if not results_agree(results[0], r, rtol=self.agree_rtol,
                                 atol=self.agree_atol):
                raise WorkloadOracleError(
                    f"{self.name}: instance {i} result disagrees with "
                    "instance 0 (identical inputs must give identical "
                    "results)")
        try:
            self.check_one(results[0])
        except WorkloadOracleError:
            raise
        except AssertionError as e:
            raise WorkloadOracleError(f"{self.name}: oracle failed: {e}") from e

    def __repr__(self) -> str:
        skew = "" if self.skew is None else f", skew={self.skew}"
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"n={self.n_instances}{skew})")
