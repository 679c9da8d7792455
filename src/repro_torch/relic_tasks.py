"""The paper's experiment, live: the JAX package's ``examples/relic_tasks.py``
as a module of ``repro_torch``. Two instances of each fine-grained kernel
(six GAP graph kernels + JSON structural parse, paper §IV) scheduled by
each strategy of ``repro_torch.tasks.strategies``; µs/iteration and
speedup over serial per kernel, every strategy's results through the
workload's oracle first. It runs on the card unless ``--device cpu`` is
given.

Run:  PYTHONPATH=src python -m repro_torch.relic_tasks [--iters 300]
          [--device cuda]
"""

from __future__ import annotations

import argparse

from repro_torch.devices import resolve_device
from repro_torch.tasks.strategies import bench_strategies
from repro_torch.workloads import PAPER_WORKLOADS, make_workload

SHOWN = ("serial", "relic_spsc", "cuda_async_stream", "fused_vmap")


def main(argv=None):
    """Returns {kernel: {strategy: µs per iteration}} for every strategy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"{'kernel':<8}" + "".join(f"{s:>22}" for s in SHOWN))
    results = {}
    for name in PAPER_WORKLOADS:
        w = make_workload(name, device=device)
        ta, tb = w.tasks
        da, db = w.dispatches
        res = results[name] = bench_strategies(
            ta, tb, w.fused_task(), dispatch_a=da, dispatch_b=db,
            iters=args.iters, device=device, check=w.check)
        base = res["serial"]
        row = f"{name:<8}"
        for s in SHOWN:
            row += f"{res[s]:>12.1f}us x{base/res[s]:>5.2f}  "
        print(row)
    if device.type == "cuda":
        print("\n(on the card: each lane issues its kernels on its own CUDA "
              "stream, so two instances can overlap there, but one "
              "interpreter lock serialises their dispatch on the host; "
              "main() returns all eight strategies' times.)")
    else:
        print("\n(on the CPU: thread-based overlap is bound by the "
              "interpreter lock; main() returns all eight strategies' times.)")
    return results


if __name__ == "__main__":
    main()
