"""The numbers a run compares with the plain reference, each beside its
limit: ``correct`` is true when every number lies at or under its limit.
The limits are the cell's (``workloads/<cell>.json``), set from the
readings of sound runs and of the control, as ``PERF.md`` records."""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Optional, Tuple


class Check:
    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.numbers: Dict[str, Tuple[float, float]] = {}
        self.readings: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        """Compare ``value`` with the cell's limit of ``name``; a number the
        cell's file gives no limit is a reading only, printed and not
        compared."""
        if name in self.limits:
            self.numbers[name] = (float(value), float(self.limits[name]))
        else:
            self.readings[name] = float(value)

    @property
    def correct(self) -> bool:
        return bool(self.numbers) and all(
            math.isfinite(v) and v <= lim for v, lim in self.numbers.values())

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, (v, lim) in self.numbers.items()}

    def report(self, out=sys.stderr) -> None:
        for n, v in self.readings.items():
            print(f"reading {n} {v!r} (not compared)", file=out)
        for n, (v, lim) in self.numbers.items():
            verdict = "ok" if math.isfinite(v) and v <= lim else "OVER"
            print(f"check {n} {v!r} limit {lim!r} {verdict}", file=out)


def rel_gap(value: float, ref: float) -> float:
    return abs(value - ref) / abs(ref)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[set] = None) -> Tuple[float, str]:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf: (gap, leaf)."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf
