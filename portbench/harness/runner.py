"""One run of one cell: set up (load, draw the weights, warm every shape the
traffic uses), measure for ``--seconds``, optionally trace a stretch more,
read the peak memory, free the program's state, check what the timed path
produced against the plain reference, read the cell's metrics and print
the result as the last line of standard output.

Exit codes: 0 with a result line; 2 when the cell or one of its files is
missing; 3 when the card the cell needs is not there; 4 when the process
loaded JAX or the JAX package. None of the last three prints a result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
from typing import List, Optional

from portbench.harness import guard
from portbench.harness.check import Check
from portbench.harness.spec import Cell, SpecError, find_cell
from portbench.harness.trace import Spans, Trace


@dataclasses.dataclass
class Window:
    """What the measured window did: its clock bounds (host seconds), the
    items (batches or steps) completed, the tokens they held, and each
    item's latency (a train step: the time its call took on the host) and
    the host time before it outside any item."""
    t0: float
    t1: float
    items: int
    tokens: int
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    gaps_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: Optional[float] = None
    window: Optional[Window] = None
    traced: Optional[Trace] = None
    memory_peak_bytes: int = 0
    check_s: Optional[float] = None
    check: Optional[Check] = None
    gc: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def collections_timed():
    """The interpreter's garbage collections while the block runs: a list
    of (generation, seconds), for the run's record."""
    out, started = [], {}

    def note(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            out.append((info["generation"], time.perf_counter() - started.pop("t")))
    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def read_metrics(run: Run) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run), each from its reader; a reader that finds nothing to read
    returns None and the metric is left out."""
    metrics = run.cell.per_layer if run.trace else run.cell.end_to_end
    out = {}
    for m in metrics:
        value = m.reader(run.cell.pkg).read(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def execute(run: Run) -> dict:
    """Drive the run and return its result (without printing it)."""
    import torch

    traffic = run.cell.kind_module().Traffic(run)
    traffic.setup()
    with collections_timed() as gcs:
        run.window = traffic.window(run.seconds)
    run.gc = gcs
    run.setup_s = run.window.t0 - run.t_start
    if run.trace:
        from portbench.harness import trace as tr
        run.traced = tr.profile(traffic.stretch, run.spans, traffic.SPANS)
    on_card = torch.device(run.device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    traffic.release()   # the program's state; the readings stay
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check = Check(run.cell.limits)
    t0 = time.perf_counter()
    traffic.check(check)
    run.check_s = time.perf_counter() - t0
    del traffic
    metrics = read_metrics(run)
    if on_card:
        from portbench.harness import card
        device = card.describe(run.cell.chips, run.memory_peak_bytes)
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0}
    result = {"correct": check.correct, "attempted": run.window.items,
              "failed": 0, "metrics": metrics, "device": device}
    if run.traced is not None:
        device["busy_s"] = run.traced.busy_s()
        device["window_s"] = run.traced.window_s
        result["breakdown"] = {"device_ops": run.traced.device_ops(),
                               "idle_gaps": run.traced.idle_gaps()}
    result["checks"] = check.as_dict()
    run.check = check
    return result


def window_record(run: Run) -> str:
    """Where a window's time went, for the record: its length and items,
    the slowest items, the longest host time between two items, and the
    interpreter's garbage collections."""
    w = run.window
    slow = sorted(enumerate(w.latencies_s), key=lambda x: -x[1])[:5]
    gap = max(enumerate(w.gaps_s), key=lambda x: x[1], default=None)
    gen2 = [t for g, t in run.gc if g == 2]
    began = time.time() - (time.perf_counter() - w.t0)
    return (f"window {w.seconds!r} s from {began!r} (epoch s), {w.items} "
            f"items; slowest (index, s) {slow}; longest time between items "
            f"{gap}; garbage collections {len(run.gc)}, "
            f"{sum(t for _, t in run.gc)!r} s, {len(gen2)} of generation 2, "
            f"longest {max(gen2, default=0.0)!r} s")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = find_cell(args.workload)
    except SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    from portbench.harness import card
    card.cache_dirs()
    try:
        card.require_cards(cell.chips)
    except card.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    result = execute(run)
    found = guard.loaded()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; the port "
              f"runs without JAX", file=sys.stderr)
        return 4
    print(f"portbench: {cell.name} seed {args.seed} on {card.power_line()}; "
          f"setup_s {run.setup_s!r}; check {run.check_s!r} s", file=sys.stderr)
    print(f"portbench: {window_record(run)}", file=sys.stderr)
    run.check.report()
    print(json.dumps(result), flush=True)
    return 0
