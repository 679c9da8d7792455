"""Host spans, and the profiler's trace of a stretch of work reduced to what
the per-layer metrics and the breakdown read.

The benchmark records its own spans around its calls into the program
(``Spans``); during a traced stretch each span is also a
``record_function`` range, so the trace holds it on the same clock as the
device's operations. A trace is written under ``TMPDIR``, read, and
deleted at once; a stretch is a few items of the cell, so the file stays
at tens of MB.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 200   # a device operation's name in the breakdown, cut to this


class Spans:
    """Named host intervals (``time.perf_counter`` seconds). While
    ``annotate`` is set each span is also a profiler range."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function(name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str, t0: float, t1: float) -> List[float]:
        """Durations of the spans ``name`` that began in [t0, t1)."""
        return [b - a for n, a, b in self.records if n == name and t0 <= a < t1]


@dataclasses.dataclass
class Trace:
    """Device operations and benchmark spans of a traced stretch, in
    microseconds on the trace's clock."""
    device: List[Tuple[str, str, float, float]]   # name, category, start, end
    spans: List[Tuple[str, float, float]]         # name, start, end
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the operations' intervals, inside the window)."""
        return sum(b - a for a, b in _union(
            [(s, e) for _, _, s, e in self.device], self.t0, self.t1)) / 1e6

    def kernel_time(self, pattern) -> Tuple[int, float]:
        """(launches, summed seconds) of the kernels whose name ``pattern``
        (a compiled regular expression) finds."""
        durs = [e - s for n, c, s, e in self.device if c == "kernel"
                and pattern.search(n) and self.t0 <= s < self.t1]
        return len(durs), sum(durs) / 1e6

    def launches(self, pattern) -> Dict[str, int]:
        """Launches in the window of the kernels whose name ``pattern`` (a
        compiled regular expression) finds, by what it found."""
        out: Dict[str, int] = {}
        for n, c, s, _ in self.device:
            found = pattern.search(n) if c == "kernel" else None
            if found and self.t0 <= s < self.t1:
                out[found.group(0)] = out.get(found.group(0), 0) + 1
        return out

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, _, s, e in self.device:
            if self.t0 <= s < self.t1:
                by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:NAME_CHARS], t]
                for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time by the benchmark span that was open on the host
        (the innermost, the latest begun), ``(no span)`` where none was."""
        busy = _union([(s, e) for _, _, s, e in self.device], self.t0, self.t1)
        gaps, at = [], self.t0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < self.t1:
            gaps.append((at, self.t1))
        by: Dict[str, float] = {}
        spans = sorted(self.spans, key=lambda s: s[1])
        for g0, g1 in gaps:
            cuts = sorted({g0, g1, *(t for _, s, e in spans for t in (s, e)
                                     if g0 < t < g1)})
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                open_ = [n for n, s, e in spans if s <= mid < e]
                name = open_[-1] if open_ else "(no span)"
                by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_events(events: List[dict], span_names) -> Trace:
    """The device operations and the named benchmark spans of a chrome
    trace; the window runs from the first span's start to the last one's
    end."""
    device = [(e["name"], e["cat"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in span_names and "dur" in e]
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    return Trace(device, spans, min(s for _, s, _ in spans),
                 max(e for _, _, e in spans))


def profile(fn: Callable[[], None], spans: Spans, span_names,
            attempts: int = 3) -> Trace:
    """Run ``fn`` under ``torch.profiler`` with the spans annotated and
    reduce its trace. The profiler now and then records no device
    operation (seen on the H100), so such a trace is taken again."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(attempts):
        spans.annotate = True
        try:
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                fn()
        finally:
            spans.annotate = False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        trace = reduce_events(events, span_names)
        if trace.device:
            return trace
    return trace
