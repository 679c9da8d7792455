"""Failure detection, straggler mitigation, and elastic planning.

At 1000+ nodes the failure model is: slow hosts (stragglers) degrade every
step (synchronous SPMD waits for the slowest); dead hosts stall the job until
it is re-gauged onto a smaller mesh from the last checkpoint. This module is
the host-side control plane for both, designed to run identically under
simulation (tests feed synthetic timings) and in production (hosts report
real step durations / heartbeats).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class StepStats:
    median: float
    mad: float
    worst_host: int
    worst_ratio: float


class StragglerMonitor:
    """Robust per-host step-time tracking (median/MAD z-scores).

    A host is flagged when its step time exceeds median + z*1.4826*MAD for
    `patience` consecutive windows — transient GC/network blips don't trip
    it, persistent slow HBM/thermal throttling does.
    """

    def __init__(self, n_hosts: int, window: int = 32, z: float = 4.0,
                 patience: int = 3):
        self.n_hosts = n_hosts
        self.window = window
        self.z = z
        self.patience = patience
        self._hist: List[deque] = [deque(maxlen=window) for _ in range(n_hosts)]
        self._strikes = [0] * n_hosts

    def record(self, host: int, seconds: float) -> None:
        self._hist[host].append(seconds)

    def record_step(self, durations: Sequence[float]) -> None:
        assert len(durations) == self.n_hosts
        for h, d in enumerate(durations):
            self.record(h, d)

    def _median(self, xs):
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def stats(self) -> Optional[StepStats]:
        means = [self._median(h) for h in self._hist if len(h)]
        if len(means) < self.n_hosts:
            return None
        med = self._median(means)
        mad = self._median([abs(m - med) for m in means]) or 1e-9
        worst = max(range(self.n_hosts), key=lambda h: means[h])
        # A zero median (e.g. synthetic all-zero timings, or sub-resolution
        # clocks) must not divide: equal-zero means ratio 1.0 (nothing is
        # slower than anything), a nonzero worst over a zero median is
        # "infinitely slower".
        if med:
            ratio = means[worst] / med
        else:
            ratio = 1.0 if means[worst] == 0 else float("inf")
        return StepStats(median=med, mad=mad, worst_host=worst,
                         worst_ratio=ratio)

    def stragglers(self) -> List[int]:
        st = self.stats()
        if st is None:
            return []
        med, mad = st.median, st.mad
        out = []
        for h in range(self.n_hosts):
            m = self._median(self._hist[h])
            if m > med + self.z * 1.4826 * mad:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.patience:
                out.append(h)
        return out


class HeartbeatTracker:
    """Dead-host detection by heartbeat timeout."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0, clock=time.time):
        self.timeout = timeout_s
        self._clock = clock
        now = clock()
        self._last: Dict[int, float] = {h: now for h in range(n_hosts)}

    def beat(self, host: int, when: Optional[float] = None) -> None:
        self._last[host] = self._clock() if when is None else when

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = self._clock() if now is None else now
        return [h for h, t in self._last.items() if now - t > self.timeout]


@dataclass(frozen=True)
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_hosts: Tuple[int, ...]
    restore_step: Optional[int]


def plan_elastic_remesh(mesh_shape: Tuple[int, ...], axes: Tuple[str, ...],
                        dead_hosts: Sequence[int], chips_per_host: int,
                        restore_step: Optional[int]) -> ElasticPlan:
    """Shrink the outermost data-ish axis by whole host groups.

    Policy: the model axes ('model', and 'pod' topology) are fixed by the
    physical wiring; capacity is shed from the 'data' axis in units of hosts
    (each host contributes chips_per_host chips along 'data'). Training
    resumes from the last checkpoint resharded onto the new mesh
    (`repro_torch.checkpoint.elastic_restore`)."""
    if chips_per_host <= 0:
        raise ValueError(
            f"chips_per_host must be positive, got {chips_per_host}")
    dead = list(dead_hosts)
    if any(h < 0 for h in dead):
        raise ValueError(f"dead_hosts must be non-negative, got {dead}")
    if len(set(dead)) != len(dead):
        # A duplicated host id is a reporting bug upstream: silently
        # deduplicating would shed less capacity than the caller asked for.
        raise ValueError(f"dead_hosts contains duplicates: {dead}")
    if not dead_hosts:
        return ElasticPlan(mesh_shape, mesh_shape, axes, (), restore_step)
    if "data" not in axes:
        raise ValueError("no data axis to shrink")
    di = axes.index("data")
    lost = len(set(dead_hosts))
    new = list(mesh_shape)
    # each lost host removes chips_per_host rows from the data axis
    new[di] = mesh_shape[di] - lost * chips_per_host
    if new[di] <= 0:
        raise RuntimeError("not enough surviving capacity for the model axes")
    return ElasticPlan(tuple(mesh_shape), tuple(new), tuple(axes),
                       tuple(sorted(set(dead_hosts))), restore_step)


class LaneSupervisor:
    """Progress-heartbeat supervision for a set of Relic lanes.

    The host-scale fault control plane wired to the Relic substrate
    (ROADMAP: ``fault.py`` was seed code until PR 8): ``RelicPool`` feeds
    each lane's existing ``_completed`` counter through this on a
    ``RELIC_HEARTBEAT_MS`` cadence, and the two seed detectors do the rest —
    :class:`HeartbeatTracker` turns "outstanding work but no progress for a
    full period" into a *stalled* flag, :class:`StragglerMonitor` turns a
    persistently slow per-task pace into a *straggler* flag.

    Deliberately passive and lane-agnostic: it holds no lane references,
    takes plain counter sequences, and never quarantines anything itself —
    liveness (``Thread.is_alive``) is the pool's own check, because a
    stalled lane may just be running one long task (which this class flags
    but cannot distinguish from a wedge; see docs/robustness.md for the
    failure model). Runs identically under a fake clock in tests.
    """

    def __init__(self, n_lanes: int, heartbeat_s: float = 0.1,
                 clock=time.monotonic, window: int = 8, z: float = 4.0,
                 patience: int = 3,
                 names: Optional[Sequence[str]] = None):
        if n_lanes <= 0:
            raise ValueError(f"n_lanes must be positive, got {n_lanes}")
        if heartbeat_s <= 0:
            raise ValueError(
                f"heartbeat_s must be positive, got {heartbeat_s}")
        if names is not None and len(names) != n_lanes:
            raise ValueError(
                f"names has {len(names)} entries for {n_lanes} lanes")
        self.n_lanes = n_lanes
        self.heartbeat_s = heartbeat_s
        #: Optional human-readable lane labels. A wiring layer that knows
        #: what the lanes *are* (Pipeline: its stages) fills this in if the
        #: caller didn't, so flag readouts can name the culprit.
        self.names: Optional[List[str]] = list(names) if names else None
        self._clock = clock
        # Two periods of silence before a lane counts as stalled: the sweep
        # cadence equals the period, so a one-period timeout would flap on
        # sampling-phase boundaries.
        self.tracker = HeartbeatTracker(n_lanes, timeout_s=2 * heartbeat_s,
                                        clock=clock)
        self.monitor = StragglerMonitor(n_lanes, window=window, z=z,
                                        patience=patience)
        self._completed = [0] * n_lanes
        self._last_sample_t = clock()

    def observe(self, completed: Sequence[int],
                outstanding: Sequence[int]) -> bool:
        """One supervision sweep: given each lane's completion counter and
        outstanding-task count, feed heartbeats and per-lane pace. Cheap to
        call often — it samples only once per heartbeat period (returns
        False when the period has not elapsed)."""
        now = self._clock()
        dt = now - self._last_sample_t
        if dt < self.heartbeat_s:
            return False
        self._last_sample_t = now
        for i in range(self.n_lanes):
            delta = completed[i] - self._completed[i]
            self._completed[i] = completed[i]
            if delta > 0:
                # Progressing: beat, and record the period's per-task pace
                # (inverse throughput) for the straggler detector.
                self.tracker.beat(i, when=now)
                self.monitor.record(i, dt / delta)
            elif outstanding[i] <= 0:
                # Idle is not dead and not slow: beat, record nothing.
                self.tracker.beat(i, when=now)
            else:
                # Outstanding work, zero progress: no beat (the stall
                # signal), and the whole silent period is its "pace".
                self.monitor.record(i, dt)
        return True

    def reset_lane(self, i: int) -> None:
        """Forget lane ``i``'s history: a respawned lane starts fresh (its
        completion counter restarts at zero, and inherited strikes would
        smear the dead predecessor's record onto its replacement)."""
        self._completed[i] = 0
        self.tracker.beat(i)
        self.monitor._hist[i].clear()
        self.monitor._strikes[i] = 0

    def stalled(self) -> List[int]:
        """Lanes with outstanding work and no progress for ~2 periods.
        Advisory: a long task and a wedged assistant look identical here."""
        return self.tracker.dead()

    def stragglers(self) -> List[int]:
        """Lanes persistently slower than their peers (median/MAD z-score
        over per-period pace, ``patience`` consecutive strikes)."""
        return self.monitor.stragglers()

    def _name(self, i: int) -> str:
        return self.names[i] if self.names else f"lane{i}"

    def stalled_names(self) -> List[str]:
        """:meth:`stalled`, mapped through ``names`` (``lane<i>`` when
        unnamed) — the readout a log line wants."""
        return [self._name(i) for i in self.stalled()]

    def straggler_names(self) -> List[str]:
        """:meth:`stragglers`, mapped through ``names``."""
        return [self._name(i) for i in self.stragglers()]
