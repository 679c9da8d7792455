"""The paper's strategy comparison (§V, Fig 1) on the port.

The port's copy of the JAX package's ``benchmarks/schedulers.py``: two
instances of one fine-grained kernel scheduled by each structure the paper
compares, timed as µs per iteration (an iteration runs both instances).
Every substrate comes from the ``repro_torch.core.schedulers`` registry and
is driven through ``repro_torch.tasks.api.TaskScope`` (submit the partner
task, run the own one, ``barrier()``), the surface every workload uses.

  serial               both instances in order on the calling thread (the
                       paper's baseline)
  relic_spsc           ``relic``: busy-wait SPSC ring, fixed roles (§VI)
  locked_queue_spin    ``spin``: mutex-protected deque, spin waits
                       (X-OpenMP-flavoured)
  locked_queue_condvar ``condvar``: bounded queue, condvar suspension (GNU
                       OpenMP-flavoured)
  threadpool_futures   ``pool``: both instances handed to a 2-worker pool,
                       the calling thread only joins (oneTBB/Taskflow)
  thread_per_task      a fresh thread for the partner task (worst-case
                       spawn cost; not a registered substrate)
  cuda_async_stream    both raw dispatches issued from one thread onto its
                       lane stream, one event behind them, one wait (the
                       reference's ``jax_async_stream``: dispatch both, one
                       sync)
  fused_vmap           the instances fused into one batched call

The task closures block until their result is ready (each on its calling
thread's own CUDA stream, ``repro_torch.tasks.streams``), so the scheduled
rows time compute. Every step returns both instances' results, so that a
caller can hold each strategy to the workload's oracle before timing it.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.devices import resolve_device
from repro_torch.tasks.api import TaskScope
from repro_torch.tasks.streams import run_blocking
from repro_torch.workloads.base import split_instances

# benchmark strategy name -> repro_torch.core.schedulers registry name
SUBSTRATE_STRATEGIES = {
    "relic_spsc": "relic",
    "locked_queue_spin": "spin",
    "locked_queue_condvar": "condvar",
    "threadpool_futures": "pool",
}

# every row, in the order bench_strategies times them
STRATEGIES = ("serial", *SUBSTRATE_STRATEGIES, "thread_per_task",
              "cuda_async_stream", "fused_vmap")

def timeit_us(step: Callable[[], Any], iters: int, warmup: int) -> float:
    """Wall-clock µs per call after warmup — the one timing loop every
    benchmark section shares (so paper/fig1/spsc numbers stay comparable)."""
    for _ in range(warmup):
        step()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    return (time.perf_counter() - t0) / iters * 1e6  # µs/iteration


def strategy_steps(task_a: Callable[[], Any], task_b: Callable[[], Any],
                   fused: Callable[[], Any], *,
                   dispatch_a: Optional[Callable[[], Any]] = None,
                   dispatch_b: Optional[Callable[[], Any]] = None,
                   device: Any = "cuda"
                   ) -> Iterator[Tuple[str, Callable[[], List[Any]]]]:
    """Yields ``(strategy, step)`` in ``STRATEGIES`` order; ``step()`` runs
    one iteration and returns ``[result_a, result_b]``.

    A generator, not a dict: a substrate's ``TaskScope`` is open only while
    its step is in hand and is closed before the next strategy is yielded,
    so a spinning Relic assistant never takes the interpreter lock from
    another row. ``task_a``/``task_b`` block until their result is ready
    (``Workload.tasks``); ``dispatch_a``/``dispatch_b`` are the raw
    dispatches (``Workload.dispatches``, whose inputs are on ``device``
    and synchronised), else ``cuda_async_stream`` degenerates to serial.
    ``fused()`` returns both instances stacked on a leading axis; its step
    splits them into two views.
    """
    device = resolve_device(device)
    dispatch_a = dispatch_a or task_a
    dispatch_b = dispatch_b or task_b

    yield "serial", lambda: [task_a(), task_b()]

    for strategy, substrate in SUBSTRATE_STRATEGIES.items():
        with TaskScope(substrate) as scope:
            if substrate == "pool":
                def step(scope=scope):
                    ha = scope.submit(task_a)
                    hb = scope.submit(task_b)
                    scope.barrier()
                    return [ha.result(), hb.result()]
            else:
                def step(scope=scope):
                    hb = scope.submit(task_b)
                    ra = task_a()
                    scope.barrier()
                    return [ra, hb.result()]
            yield strategy, step

    def tpt_step():
        out: Dict[str, Any] = {}

        def partner():
            try:
                out["b"] = task_b()
            except BaseException as e:   # re-raised on the calling thread
                out["error"] = e

        t = threading.Thread(target=partner)
        t.start()
        try:
            ra = task_a()
        finally:
            t.join()
        if "error" in out:
            raise out["error"]
        return [ra, out["b"]]

    yield "thread_per_task", tpt_step

    yield "cuda_async_stream", lambda: run_blocking(
        lambda: [dispatch_a(), dispatch_b()], device)

    yield "fused_vmap", lambda: split_instances(fused(), 2)


def bench_strategies(task_a: Callable[[], Any], task_b: Callable[[], Any],
                     fused: Callable[[], Any], *,
                     dispatch_a: Optional[Callable[[], Any]] = None,
                     dispatch_b: Optional[Callable[[], Any]] = None,
                     iters: int = 1000, warmup: int = 50,
                     device: Any = "cuda",
                     check: Optional[Callable[[List[Any]], None]] = None
                     ) -> Dict[str, float]:
    """Returns µs/iteration per strategy (``STRATEGIES``); an iteration runs
    both instances. ``check``, when given (``Workload.check``), is handed
    each strategy's results once, before that strategy is timed."""
    out: Dict[str, float] = {}
    for strategy, step in strategy_steps(task_a, task_b, fused,
                                         dispatch_a=dispatch_a,
                                         dispatch_b=dispatch_b, device=device):
        if check is not None:
            check(step())
        # a thread spawn a step: the reference times a quarter of the
        # iterations, never fewer than 100
        n = max(iters // 4, 100) if strategy == "thread_per_task" else iters
        out[strategy] = timeit_us(step, n, warmup)
    return out


def fig4_geomeans(results: Dict[str, Dict[str, float]]
                  ) -> Tuple[Dict[str, float], float]:
    """The paper's Fig 4 reduction of ``{kernel: bench_strategies(...)}``:
    the geomean speedup over serial per strategy, a kernel that a strategy
    slows counted as 1.0 (the developer would keep the serial version), and
    Relic's gain over the best other framework (serial and the fused call
    are not frameworks), as a fraction."""
    geo = {}
    for strategy in STRATEGIES:
        sps = [max(r["serial"] / r[strategy], 1.0) for r in results.values()]
        geo[strategy] = math.exp(sum(math.log(s) for s in sps) / len(sps))
    best_other = max((v for k, v in geo.items()
                      if k not in ("relic_spsc", "fused_vmap", "serial")),
                     default=1.0)
    return geo, geo["relic_spsc"] / best_other - 1
