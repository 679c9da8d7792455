"""Spans inside the program: the card's busy time by model region.

``span(name)`` is a context manager placed around a region of the forward
(``models/lm.py``, ``models/attention.py``, ``models/layers.py``). Spans are
off unless their reader turns them on for a stretch of its own
(``recording()``, which ``profile`` uses): off, a span is one flag test
and a shared no-op context. It never enters ``record_function`` (about 9
us with no profiler running, 23 us under one), so neither an untimed run
nor another profiler's trace (the benchmark's traced stretch,
``chip_smoke.py``'s profiles) carries any cost of it. On, a span is a
``record_function`` range, nothing more: the program keeps no record and
makes no CUDA event.

``profile(fn, on_card)`` runs ``fn`` under ``torch.profiler`` with the
spans on and gives each device operation (kernel, copy, memset) to the
innermost span open on the host thread that launched it, matched by the
launch's correlation id. A region's time is the summed duration of its
operations: the time the card was busy for it, not the time it held the
stream, so a stall of the host inside the region (the spans' own cost
included) does not count. On the CPU the host runs the operations, and
each outermost ``cpu_op`` is given to the span open at its start.

The names, which the benchmark's ``*_ms.score`` metrics and ``PERF.md``
use (``NAMES``):

``lm.forward`` ``lm_forward``; ``lm.embed`` the embedding (and a VLM's
patches); ``lm.block`` each block (its own time: the residual adds);
``norm`` every ``layers.norm``; ``attn.qkv`` ``_project_qkv``;
``attn.rope`` q's and k's RoPE; ``attn.core`` ``attention_core``;
``attn.out`` ``_output``; ``mlp`` ``layers.mlp``; ``lm.head`` the final
norm and the unembedding; ``lm.log_likelihood`` ``layers.log_likelihood``.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Callable, Dict, List, NamedTuple

import torch

NAMES = ("lm.forward", "lm.embed", "lm.block", "norm", "attn.qkv",
         "attn.rope", "attn.core", "attn.out", "mlp", "lm.head",
         "lm.log_likelihood")
NO_SPAN = "(no span)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

_OFF = contextlib.nullcontext()
_on = False


def span(name: str):
    """The profiler range ``name`` while spans are on; else a no-op."""
    return torch.profiler.record_function(name) if _on else _OFF


@contextlib.contextmanager
def recording():
    """Turn the spans on for the block."""
    global _on
    _on = True
    try:
        yield
    finally:
        _on = False


class Region(NamedTuple):
    count: int        # the span's ranges (NO_SPAN: 0)
    busy_ms: float    # the summed duration of the operations it launched


def busy(events: List[dict], on_card: bool) -> Dict[str, Region]:
    """{span name: Region} of a chrome trace's ``events``, each operation
    given to the innermost span open at its launch; ``NO_SPAN`` holds the
    operations launched outside every span."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in NAMES and "dur" in e]
    if on_card:
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        ops = []
        for e in events:
            at = launch.get(e.get("args", {}).get("correlation"))
            if e.get("cat") in DEVICE_CATS and "dur" in e and at is not None:
                ops.append((at["tid"], float(at["ts"]), float(e["dur"])))
    else:
        ops = _outermost([e for e in events if e.get("cat") == "cpu_op"
                          and "dur" in e])
    # One sweep a thread: range starts and ends, and launch points, in time
    # order (at one instant: ends, then starts outermost first, then launches).
    points: Dict[object, list] = {}
    for r in ranges:
        s, d = float(r["ts"]), float(r["dur"])
        points.setdefault(r["tid"], []).extend(
            [(s, 1, -d, r["name"]), (s + d, 0, 0.0, None)])
    for tid, t, d in ops:
        points.setdefault(tid, []).append((t, 2, d, None))
    count: Dict[str, int] = {}
    for r in ranges:
        count[r["name"]] = count.get(r["name"], 0) + 1
    total: Dict[str, float] = {}
    for pts in points.values():
        stack: List[str] = []
        for _, kind, d, name in sorted(pts, key=lambda p: p[:3]):
            if kind == 1:
                stack.append(name)
            elif kind == 0:
                stack.pop()
            else:
                owner = stack[-1] if stack else NO_SPAN
                total[owner] = total.get(owner, 0.0) + d / 1e3
    return {n: Region(count.get(n, 0), total.get(n, 0.0))
            for n in sorted(set(count) | set(total))}


def _outermost(ops: List[dict]) -> List[tuple]:
    """(tid, start, duration) of the ops that no other op on their thread
    contains."""
    out, ends = [], {}
    for e in sorted(ops, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        s, d = float(e["ts"]), float(e["dur"])
        if s >= ends.get(e["tid"], float("-inf")):
            out.append((e["tid"], s, d))
            ends[e["tid"]] = s + d
    return out


def profile(fn: Callable[[], None], on_card: bool,
            attempts: int = 3) -> Dict[str, Region]:
    """Run ``fn`` under ``torch.profiler`` with the spans on and give its
    device operations to the spans (``busy``). The profiler now and then
    records no device operation on the card, so such a run is made again."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    for _ in range(attempts):
        with recording(), torch_profile(activities=acts) as prof:
            fn()
            if on_card:
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="repro_spans_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        out = busy(events, on_card)
        if not on_card or any(r.busy_ms > 0 for r in out.values()):
            return out
    return out
