"""Graceful-preemption handling. A copy of ``tpunet/utils/preemption.py``.

The reference has no failure story at all — a SLURM walltime kill or
node preemption loses everything since the epoch-0 restart is the only
path (SURVEY.md section 5). TPU-VM spot/preemptible instances send
SIGTERM with a short grace window; this guard turns that into a clean
stop: the signal sets a flag, the Trainer notices it between steps,
saves a full-state checkpoint and exits, and ``--resume`` continues.

Grace-window discipline (docs/elasticity.md):

- ``deadline_s`` tells the guard how much grace the platform grants
  after the first SIGTERM. ``remaining()`` is then the budget the
  trainer has left — it skips the eval pass when preempted and bounds
  the checkpoint-durability wait to the remaining grace instead of
  blocking past the platform's kill.
- a **second** SIGTERM during the grace window escalates
  (``escalated``): the platform (or an impatient operator) is saying
  "now", so the trainer abandons the in-flight checkpoint work and
  exits immediately instead of finishing a save that will be
  SIGKILLed mid-write anyway. (Previously a repeat signal was
  silently absorbed by the already-set flag.)

The handler only sets flags and reads a monotonic clock
(async-signal-safe); all real work happens on the main thread at a
step boundary. Previous handlers are chained so embedding tpunet_torch in
a larger program keeps its signal behavior.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Iterable, Optional


class PreemptionGuard:
    """Install with ``install()``; poll ``requested`` / ``escalated``
    between steps; budget shutdown work with ``remaining()``."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 deadline_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self._signals = tuple(signals)
        self._previous: Optional[dict] = None
        self._clock = clock
        self.deadline_s = float(deadline_s)
        self.requested = False
        self.escalated = False
        self.requested_at: Optional[float] = None

    def _handler(self, signum, frame):
        if self.requested:
            # Second signal inside the grace window: escalate. A
            # platform that double-signals means the window is over.
            self.escalated = True
        else:
            self.requested = True
            self.requested_at = self._clock()
        prev = (self._previous or {}).get(signum)
        if callable(prev):
            prev(signum, frame)

    def request(self, escalate: bool = False) -> None:
        """Programmatic stop request. Idempotent by default — the
        cross-host stop agreement re-requests every poll, and that
        must not count as a second preemption; pass ``escalate=True``
        to mirror a repeated signal."""
        if self.requested:
            if escalate:
                self.escalated = True
        else:
            self.requested = True
            self.requested_at = self._clock()

    def remaining(self) -> Optional[float]:
        """Grace seconds left (>= 0), or None when no deadline is
        configured or no preemption has been requested — callers pass
        it straight into bounded waits."""
        if not self.requested or self.deadline_s <= 0 \
                or self.requested_at is None:
            return None
        return max(0.0, self.deadline_s
                   - (self._clock() - self.requested_at))

    def install(self) -> "PreemptionGuard":
        if self._previous is None:
            self._previous = {}
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        if self._previous is not None:
            for s, prev in self._previous.items():
                signal.signal(s, prev if prev is not None else signal.SIG_DFL)
            self._previous = None

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
