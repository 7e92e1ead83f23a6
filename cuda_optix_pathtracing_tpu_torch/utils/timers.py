"""Timers: an exponential moving average of lap times plus the total
wall clock (counterpart of the reference ``utils/timers.py``), for
per-batch throughput lines."""

from __future__ import annotations

import time


class AvgAndTotalTimer:
    """Exponential-moving-average of lap times plus total elapsed."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema = 0.0
        self.total = 0.0
        self.laps = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self.total += dt
        self.ema = dt if self.laps == 0 else self.alpha * dt + (1 - self.alpha) * self.ema
        self.laps += 1
        return dt

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.lap()
        return False
