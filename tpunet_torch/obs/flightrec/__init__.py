"""Black-box flight recorder: crash forensics for the host runtime.

A copy of ``tpunet/obs/flightrec/`` (framework-free).

Three instruments, one goal — when a run dies, the last milliseconds
are evidence, not a shrug:

- ``ring``     — crash-durable (file-backed mmap) ring of recent
  structured events: span begin/end, alerts, checkpoint / export /
  prefetch state transitions. ~1-2 us per event, default-ON.
- ``threads``  — the host-thread registry: every background thread
  (the native prefetcher, the serve engine loop, the classify
  batcher) registers with a name, heartbeat, and stall budget;
  exported as ``thread_*`` gauges and feeding the watchdog's
  ``thread_stalled`` alert.
- ``crash``    — crash handlers (faulthandler + the C extension's
  SIGSEGV/SIGABRT/SIGBUS hook, ``tpunet_torch/data/native.py``) plus a
  post-mortem watcher process that assembles a torn-write-safe
  ``crash_report.json`` from the ring tail, per-thread Python stacks,
  the native batcher journal and the last device ``memory_stats()``
  sample.

This module owns the process-global singleton: ``install()`` arms the
recorder, ``record()`` is the no-op-when-disabled event hook call
sites use (one global read + None check), ``close()`` marks a clean
shutdown. ``tpunet_torch/obs/__init__.py`` wires it to the trainer's
run and the serving CLI (``tpunet_torch/serve/__main__.py``) arms it;
``python -m tpunet_torch.obs.cli.crash_report`` renders reports (the
file layout is the JAX package's).
"""

from __future__ import annotations

from typing import Callable, Optional

from tpunet_torch.obs.flightrec.crash import (FlightRecorder, crash_record,
                                              prior_crash_report)
from tpunet_torch.obs.flightrec.ring import EventRing
from tpunet_torch.obs.flightrec.threads import (BUSY, IDLE, THREADS,
                                                ThreadHandle, ThreadRegistry)

__all__ = [
    "BUSY", "EventRing", "FlightRecorder", "IDLE", "THREADS",
    "ThreadHandle", "ThreadRegistry", "close", "crash_record", "get",
    "install", "prior_crash_report", "record", "register_thread",
]

_REC: Optional[FlightRecorder] = None


def install(directory: str, **kw: object) -> FlightRecorder:
    """Arm the process-global recorder (closing any previous one —
    crash handlers and the watcher are process-wide, so the newest
    run dir wins)."""
    global _REC
    if _REC is not None:
        _REC.close()
    _REC = FlightRecorder(directory, **kw).install()
    return _REC


def get() -> Optional[FlightRecorder]:
    return _REC


def record(kind: str, msg: str = "") -> None:
    """Append one event to the installed recorder's ring; a cheap
    no-op (one global read) when no recorder is armed — call sites
    never need to guard."""
    rec = _REC
    if rec is not None:
        rec.record(kind, msg)


def register_thread(name: str, stall_after_s: float = 0.0,
                    clock: Optional[Callable[[], float]] = None
                    ) -> ThreadHandle:
    """Register a background thread in the process-global registry
    (convenience over ``THREADS.register``)."""
    import time
    return THREADS.register(name, stall_after_s,
                            clock if clock is not None
                            else time.monotonic)


def close(recorder: Optional[FlightRecorder] = None) -> None:
    """Clean-shutdown the global recorder (or only ``recorder`` if it
    still IS the global one — a newer install must not be closed by
    its predecessor's owner)."""
    global _REC
    if _REC is None or (recorder is not None and recorder is not _REC):
        return
    _REC.close()
    _REC = None
