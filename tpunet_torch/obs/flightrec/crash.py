"""FlightRecorder: always-on crash forensics for one process.

A copy of ``tpunet/obs/flightrec/crash.py``.

Capture is split by what each death mode allows:

- **events**: the Python event ring lives in a file-backed mmap
  (ring.py) — durable the instant an event is recorded, under every
  death mode including SIGKILL.
- **per-thread Python stacks**: ``faulthandler.enable`` onto a file in
  the flightrec dir — the only async-signal-safe way to get
  interpreter stacks out of a SIGSEGV/SIGABRT/SIGBUS.
- **native journal**: the C extension's op ring
  (``tpunet_torch/data/native.py``, ``cxx/batcher.cc``) is spilled to
  disk by its own C-level signal handler (``tn_crash_install``),
  installed AFTER faulthandler so the chain runs C-journal -> Python
  stacks -> default action: the last N alloc/free/enqueue/shutdown ops
  the batcher performed before the process died.
- **report assembly**: a watcher subprocess (watch.py) detects parent
  death via pipe EOF and materializes ``crash_report.json`` — no
  crash-time JSON, no malloc in handlers, works for OOM-kills too.

One recorder per process (crash handlers are process-global); the
module-level ``install``/``record``/``close`` in ``__init__`` manage
the singleton. Everything here is best-effort by design: the recorder
must never be the thing that kills a healthy run.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time
from typing import Optional, Tuple

from tpunet_torch.obs.flightrec import report as _report
from tpunet_torch.obs.flightrec.ring import DEFAULT_SLOTS, EventRing
from tpunet_torch.obs.flightrec.threads import THREADS

# One watcher process serves every recorder install in this process's
# lifetime (re-pointed with DIR lines); spawning per-install would leak
# a subprocess per Trainer in test suites.
_WATCHER: Optional[subprocess.Popen] = None


def _watcher_send(line: str) -> None:
    global _WATCHER
    if _WATCHER is None or _WATCHER.poll() is not None:
        return
    try:
        _WATCHER.stdin.write((line + "\n").encode())
        _WATCHER.stdin.flush()
    except (OSError, ValueError):
        _WATCHER = None


def _ensure_watcher() -> bool:
    global _WATCHER
    if _WATCHER is not None and _WATCHER.poll() is None:
        return True
    watch_py = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "watch.py")
    try:
        # By file path, not -m: the watcher must not import tpunet_torch.obs
        # (and with it torch) just to idle next to the run.
        _WATCHER = subprocess.Popen(
            [sys.executable, watch_py], stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            close_fds=True)
        return True
    except OSError:
        _WATCHER = None
        return False


class FlightRecorder:
    def __init__(self, directory: str, *, process_index: int = 0,
                 n_events: int = DEFAULT_SLOTS, watcher: bool = True,
                 native: bool = True, run_id: str = ""):
        self.directory = (os.path.join(directory, "flightrec")
                          if directory else "")
        self.process_index = process_index
        self.n_events = n_events
        self.run_id = run_id
        self._want_watcher = watcher and bool(self.directory)
        self._want_native = native
        self.ring: Optional[EventRing] = None
        self._stacks_file = None
        self._prev_faulthandler = False
        self._installed = False
        self._closed = False

    def _path(self, name: str) -> str:
        return _report.artifact(self.directory, name, self.process_index)

    # -- lifecycle -------------------------------------------------------

    def install(self) -> "FlightRecorder":
        if self._installed:
            return self
        self._installed = True
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            # A fresh incarnation: the clean marker and any stale
            # capture files belong to the previous one — a report
            # assembled later must not mix this incarnation's meta
            # with a dead incarnation's thread/memory snapshots.
            for name in (_report.CLEAN_MARKER,
                         _report.NATIVE_JOURNAL_TXT,
                         _report.THREADS_JSON,
                         _report.DEVICE_MEM_JSON):
                try:
                    os.unlink(self._path(name))
                except OSError:
                    pass
            self._write_json(_report.META_JSON, {
                "pid": os.getpid(),
                "argv": sys.argv,
                "run_id": self.run_id,
                "process_index": self.process_index,
                "started_t": round(time.time(), 3),
            })
        self.ring = EventRing(
            self._path(_report.EVENTS_RING) if self.directory else None,
            self.n_events)
        if self.directory:
            self._install_faulthandler()
            if self._want_native:
                self._install_native()
            if self._want_watcher and _ensure_watcher():
                # The pid rides along so a lingering watcher from a
                # PREVIOUS incarnation of a reused run dir can never
                # assemble a report over this incarnation's files
                # (watch.py checks it against meta.json). The path is
                # LAST and parsed as the remainder of the line, so run
                # dirs with spaces survive the wire format.
                _watcher_send(f"DIR {self.process_index} "
                              f"{os.getpid()} {self.directory}")
        self.record("flightrec", f"installed pid={os.getpid()}")
        return self

    def _install_faulthandler(self) -> None:
        try:
            self._prev_faulthandler = faulthandler.is_enabled()
            # Keep the file object referenced for the process's life —
            # faulthandler holds only the fd.
            self._stacks_file = open(self._path(_report.STACKS_TXT), "w")
            faulthandler.enable(file=self._stacks_file,
                                all_threads=True)
        except OSError:
            self._stacks_file = None

    def _install_native(self) -> None:
        """Arm the C extension's journal spill: its SIGSEGV/SIGABRT/
        SIGBUS handler writes the native op ring to the flightrec dir
        and then chains to the handler faulthandler just installed
        (install order is the chain order)."""
        try:
            from tpunet_torch.data import native
            native.crash_install(
                self._path(_report.NATIVE_JOURNAL_TXT))
        except Exception:
            pass          # no toolchain / no library: python-only report

    def close(self) -> None:
        """Clean shutdown: tell the watcher this was not a crash."""
        if self._closed or not self._installed:
            return
        self._closed = True
        self.record("flightrec", "clean close")
        if self.directory:
            try:
                with open(self._path(_report.CLEAN_MARKER), "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass
            _watcher_send("CLEAN")
        if self._stacks_file is not None:
            try:
                # Hand faulthandler back to whoever had it (pytest's
                # plugin enables it on stderr) instead of leaving it
                # aimed at a file we are about to close.
                if self._prev_faulthandler:
                    faulthandler.enable()
                else:
                    faulthandler.disable()
                self._stacks_file.close()
            except (OSError, ValueError):
                pass
            self._stacks_file = None
        if self.ring is not None:
            self.ring.close()

    # -- capture ---------------------------------------------------------

    def record(self, kind: str, msg: str = "") -> None:
        if self.ring is not None and not self._closed:
            self.ring.record(kind, msg)

    def set_device_memory(self, mem: Optional[dict]) -> None:
        """Refresh the last-known device ``memory_stats()`` snapshot
        (epoch boundaries). Crash handlers cannot query a device, so
        the report carries the most recent sample."""
        if self.directory and mem:
            self._write_json(_report.DEVICE_MEM_JSON, {
                "sampled_t": round(time.time(), 3), "devices": mem})

    def refresh_threads(self) -> None:
        """Persist the host-thread registry snapshot (epoch
        boundaries) so the report can say what each background thread
        was last doing."""
        if self.directory:
            self._write_json(_report.THREADS_JSON, THREADS.snapshot())

    def _write_json(self, name: str, obj) -> None:
        path = self._path(name)
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(obj, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass


# -- prior-crash detection ----------------------------------------------


def prior_crash_report(directory: str, process_index: int = 0
                       ) -> Tuple[Optional[dict], Optional[str]]:
    """(report dict, archived path) when the previous incarnation of
    this run dir left a crash report; (None, None) otherwise. The
    report file is archived (renamed with its mtime) so one crash
    emits one ``obs_crash`` record across restarts."""
    if not directory:
        return None, None
    path = _report.artifact(os.path.join(directory, "flightrec"),
                            _report.REPORT_NAME, process_index)
    if not os.path.isfile(path):
        return None, None
    try:
        with open(path) as f:
            rep = json.load(f)
        root, ext = os.path.splitext(path)
        archived = f"{root}.{int(os.path.getmtime(path))}{ext}"
        os.replace(path, archived)
    except (OSError, ValueError):
        return None, None
    return rep, archived


def crash_record(rep: dict, path: str) -> dict:
    """The ``obs_crash`` record summarizing one crash report
    (docs/metrics_schema.md) — emitted through a Registry so it
    reaches metrics.jsonl, live exporters, and the fleet
    aggregator."""
    nj = rep.get("native_journal") or {}
    stacks = rep.get("stacks") or {}
    meta = rep.get("meta") or {}
    return {
        "cause": rep.get("cause", "unknown"),
        "signal": rep.get("signal"),
        "report_path": path,
        "crashed_pid": meta.get("pid"),
        "events": len(rep.get("events") or ()),
        "stack_threads": len(stacks.get("threads") or ()),
        "native_ops": len(nj.get("ops") or ()),
        "assembled_t": rep.get("assembled_t"),
    }
