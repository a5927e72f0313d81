"""Wall-clock timing for the epoch/total timers and per-step laps.

A copy of ``tpunet/utils/timing.py``.

``time.perf_counter`` throughout, not the reference's ``time.time``
(cifar10_mpi_mobilenet_224.py:161,164,227,242): perf_counter is
monotonic with the highest available resolution, so NTP clock steps on
a long-running host can never produce negative or wildly wrong epoch
times — and sub-millisecond step laps are actually resolvable.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.start = time.perf_counter()
        self._lap = self.start

    def reset(self) -> None:
        self.start = time.perf_counter()
        self._lap = self.start

    def elapsed(self) -> float:
        """Seconds since construction/reset (lap state untouched)."""
        return time.perf_counter() - self.start

    def lap(self) -> float:
        """Seconds since the previous ``lap()`` (or construction/
        reset) — the per-step accounting primitive."""
        now = time.perf_counter()
        dt = now - self._lap
        self._lap = now
        return dt
