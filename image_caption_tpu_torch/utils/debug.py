"""Step timing for the training loop.

``StepTimer`` counts steps per second on the host clock, with the first
step (which carries the kernels' build and first-use set-up) left out.
"""

from __future__ import annotations

import time
from typing import Optional


class StepTimer:
    """Steps/sec with the first (set-up bearing) step excluded."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._steps = 0

    def step(self, n: int = 1) -> None:
        """Record n steps completed by one call (n > 1: a K-step call).  The
        first call is excluded entirely: the clock starts when it ends."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        else:
            self._steps += n

    @property
    def steps_per_sec(self) -> Optional[float]:
        if self._t0 is None or self._steps == 0:
            return None
        return self._steps / (time.perf_counter() - self._t0)
