"""Windowed fidelity drift and the replan trigger.

A serving fleet watches one scalar per plan execution: the mean
log(wall/pred) fidelity ratio.  Comparing the latest value against the
first (`ServingEngine.drift_latest_vs_first`) is fragile — a single noisy
first run poisons the baseline forever, and a single noisy latest run
fires a false trigger.  `windowed_drift` compares a trailing-window
*median* against a baseline-window *median*, so isolated outliers on
either end are absorbed.

`DriftMonitor` turns the scalar into an actionable replan trigger with
hysteresis (re-arms only after drift falls back below
``threshold - hysteresis``) and a cooldown (minimum observations between
triggers), so a plan oscillating around the threshold cannot thrash the
planner.  The serving scheduler keeps one monitor per (batch, seq)
bucket and replans the bucket in place when its monitor fires.  The
port's copy of `repro.measure.drift` (plain Python).
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional, Sequence


def windowed_drift(values: Sequence[float], *, window: int = 4,
                   baseline: int = 4) -> Optional[float]:
    """Median of the trailing `window` values minus the median of the
    first `baseline` values (the latest value never enters the baseline,
    so two observations reproduce a latest-vs-first comparison at half
    scale).  None until two values exist.

    Units are whatever the inputs are — for fidelity logs, mean
    log(wall/pred), so 0.0 = stable and log(1.5) ~= 0.405 = "the plan
    runs 1.5x slower than it was priced"."""
    if len(values) < 2:
        return None
    base = statistics.median(list(values[:-1])[:baseline])
    trail = statistics.median(values[-window:])
    return trail - base


@dataclasses.dataclass
class DriftMonitor:
    """Hysteresis-and-cooldown wrapper around `windowed_drift`.

    `observe(value)` appends one fidelity observation and returns True
    when a replan should fire: drift above `threshold` while armed and
    out of cooldown.  After firing the monitor disarms until drift falls
    below ``threshold - hysteresis``; callers that replan in place should
    instead call `reset()` — the new plan starts a fresh baseline.
    """

    threshold: float = 0.35       # log-ratio units: ~1.4x slower
    hysteresis: float = 0.15
    window: int = 4
    baseline: int = 4
    cooldown: int = 6             # min observations between triggers
    values: List[float] = dataclasses.field(default_factory=list)
    armed: bool = True
    _last_trigger: int = -10**9

    @property
    def drift(self) -> Optional[float]:
        return windowed_drift(self.values, window=self.window,
                              baseline=self.baseline)

    def observe(self, value: float) -> bool:
        self.values.append(value)
        d = self.drift
        if d is None:
            return False
        if not self.armed:
            if d < self.threshold - self.hysteresis:
                self.armed = True
            return False
        if d > self.threshold and \
                len(self.values) - self._last_trigger >= self.cooldown:
            self.armed = False
            self._last_trigger = len(self.values)
            return True
        return False

    def reset(self) -> None:
        """Start a fresh baseline (call after an in-place replan: the new
        plan's fidelity history begins empty and the monitor re-arms)."""
        self.values.clear()
        self.armed = True
        self._last_trigger = -10**9
