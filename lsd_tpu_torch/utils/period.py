"""EMA frame-rate estimator (ref: util/period_calculator.py:3-10); a copy of
``lsd_tpu/utils/period.py`` for the port."""
from __future__ import annotations

import time


class PeriodCalculator:
    def __init__(self, alpha: float = 0.9):
        self.alpha = alpha
        self.last = None
        self.period = 0.0

    def tick(self) -> float:
        now = time.monotonic()
        if self.last is not None:
            dt = now - self.last
            self.period = self.alpha * self.period + (1 - self.alpha) * dt \
                if self.period > 0 else dt
        self.last = now
        return self.fps

    @property
    def fps(self) -> float:
        return 1.0 / self.period if self.period > 0 else 0.0
