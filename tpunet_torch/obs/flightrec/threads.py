"""Host-thread registry: every background thread, one place.

The host runtime that competes with the step loop — the orbax async
checkpoint writer, the telemetry exporter drain thread, the watchdog
monitor, the native prefetcher, the serving engine loop — used to be
invisible: no inventory, no liveness, no way to say WHICH thread a
wedged process was waiting on. Threads now register here with a name
and heartbeat; the registry exports ``thread_*`` gauges (age since
last beat, cumulative beats) and feeds the watchdog's
``thread_stalled`` alert (the JAX package's watchdog): a thread that
declared a stall budget and has been ``busy`` past it pages through
the existing alert/exporter path.

``beat()`` is one clock read + three attribute stores (atomic enough
under the GIL) — safe on any thread at any rate. Stall detection only
judges *busy* threads: a drain thread parked on an empty queue is
idle, not stalled, so handles flip ``idle``/``busy`` around their
blocking work.

The registry is process-global (``THREADS``) because crash forensics
is process-global: the flight recorder snapshots it into crash
reports, and re-registering a name replaces the old handle (thread
restarts, successive Trainer instances in one process).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

IDLE = "idle"
BUSY = "busy"


class ThreadHandle:
    __slots__ = ("name", "stall_after_s", "state", "last_beat", "beats",
                 "ident", "started_t", "_clock")

    def __init__(self, name: str, stall_after_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.stall_after_s = float(stall_after_s)
        self._clock = clock
        self.state = IDLE
        self.last_beat = clock()
        self.started_t = self.last_beat
        self.beats = 0
        self.ident: Optional[int] = None

    def beat(self, state: Optional[str] = None) -> None:
        """Heartbeat from the owning thread; optionally transitions
        the idle/busy state in the same call. State *transitions*
        (not same-state beats) also land in the flight-recorder ring
        — the busy/idle periods the unified timeline exporter
        (the JAX package's timeline exporter) renders as per-thread
        tracks; one ring write per flip, nothing on same-state
        beats."""
        if state is not None and state != self.state:
            self.state = state
            from tpunet_torch.obs import flightrec
            flightrec.record("thread", f"{state} {self.name}")
        elif state is not None:
            self.state = state
        self.last_beat = self._clock()
        self.beats += 1
        if self.ident is None:
            self.ident = threading.get_ident()

    def set_state(self, state: str) -> None:
        self.beat(state)

    def age_s(self, now: Optional[float] = None) -> float:
        return (now if now is not None else self._clock()) - self.last_beat

    def stalled(self, now: Optional[float] = None) -> bool:
        """True when this thread declared a budget, is marked busy,
        and has not beaten within it."""
        return (self.stall_after_s > 0 and self.state == BUSY
                and self.age_s(now) > self.stall_after_s)


def _gauge_key(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z]+", "_", name).strip("_")


class ThreadRegistry:
    """Name -> handle map; mutation is locked, beats are not (a beat
    touches only its own handle)."""

    def __init__(self):
        self._handles: Dict[str, ThreadHandle] = {}
        self._lock = threading.Lock()

    def register(self, name: str, stall_after_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic
                 ) -> ThreadHandle:
        handle = ThreadHandle(name, stall_after_s, clock)
        with self._lock:
            self._handles[name] = handle
        return handle

    def unregister(self, name: str) -> None:
        with self._lock:
            self._handles.pop(name, None)

    def handles(self) -> List[ThreadHandle]:
        with self._lock:
            return sorted(self._handles.values(), key=lambda h: h.name)

    def stalled(self, now: Optional[float] = None
                ) -> List[Tuple[ThreadHandle, float]]:
        """Every registered thread currently past its stall budget,
        with its heartbeat age."""
        out = []
        for h in self.handles():
            if h.stalled(now):
                out.append((h, h.age_s(now)))
        return out

    def export_gauges(self, registry: object) -> None:
        """Mirror the registry into ``thread_*`` gauges on an obs
        Registry (docs/metrics_schema.md "Registry snapshot keys"):
        ``thread_count`` plus per-thread ``thread_<name>_age_s`` /
        ``thread_<name>_beats``."""
        handles = self.handles()
        registry.gauge("thread_count").set(len(handles))
        for h in handles:
            key = _gauge_key(h.name)
            registry.gauge(f"thread_{key}_age_s").set(round(h.age_s(), 3))
            registry.gauge(f"thread_{key}_beats").set(h.beats)

    def snapshot(self) -> List[dict]:
        """JSON-able rows for the crash report."""
        return [{"name": h.name, "state": h.state,
                 "age_s": round(h.age_s(), 3), "beats": h.beats,
                 "stall_after_s": h.stall_after_s, "ident": h.ident}
                for h in self.handles()]


# The process-wide registry every subsystem registers into.
THREADS = ThreadRegistry()
