"""Crash-report assembly: flightrec artifacts -> crash_report.json.

The in-crash capture paths are deliberately dumb (an mmap'd event
ring, a faulthandler text dump, a native journal spill from a C signal
handler) because they must work while the process is dying; this
module is where the intelligence lives. It runs OUTSIDE the crash: in
the post-mortem watcher (watch.py) after the training process dies, in
``python -m tpunet_torch.obs.cli.crash_report``, and in tests.

Stdlib-only and dual-mode importable (as
``tpunet_torch.obs.flightrec.report`` or as a bare script module): the
watcher executes this by file path so it never imports ``tpunet_torch``
— and therefore never pays a torch import or its resident memory — while
it idles alongside a training run.

The report file write is torn-write-safe (tmp + ``os.replace``): a
reader either sees no report or a complete one, never half a JSON
object.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import List, Optional

if __package__:
    from tpunet_torch.obs.flightrec import ring as _ring
else:                                        # script mode (the watcher)
    import ring as _ring                     # type: ignore

REPORT_VERSION = 1
REPORT_NAME = "crash_report.json"
CLEAN_MARKER = "clean"

# File names inside the flightrec dir; multi-process runs suffix
# ``.pN`` before the extension for every process but the coordinator.
EVENTS_RING = "events.ring"
STACKS_TXT = "stacks.txt"
NATIVE_JOURNAL_TXT = "native_journal.txt"
DEVICE_MEM_JSON = "device_mem.json"
THREADS_JSON = "threads.json"
META_JSON = "meta.json"

_SIGNAMES = {4: "SIGILL", 6: "SIGABRT", 7: "SIGBUS", 8: "SIGFPE",
             11: "SIGSEGV"}

# Mirrors the JournalOp enum in cxx/batcher.cc (bump together).
NATIVE_OPS = {1: "create", 2: "destroy", 3: "epoch_start",
              4: "epoch_reject", 5: "next_pop", 6: "next_eof",
              7: "batch_alloc", 8: "batch_push", 9: "worker_enter",
              10: "worker_exit", 11: "stop_begin", 12: "stop_joined",
              13: "gather"}


def artifact(directory: str, name: str, process_index: int = 0) -> str:
    """Path of one flightrec artifact; non-coordinator processes get a
    ``.pN`` suffix so a shared run dir never collides."""
    if process_index:
        root, ext = os.path.splitext(name)
        name = f"{root}.p{process_index}{ext}"
    return os.path.join(directory, name)


def _read_text(path: str) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def parse_stacks(text: str) -> dict:
    """Parse a faulthandler dump into {fatal, threads:[{ident,
    current, frames}]}; the raw text rides along (the parse is a
    convenience, the evidence is the dump)."""
    fatal = None
    m = re.search(r"^Fatal Python error: (.+)$", text, re.M)
    if m:
        fatal = m.group(1).strip()
    threads: List[dict] = []
    current: Optional[dict] = None
    for line in text.splitlines():
        m = re.match(r"^(Current thread|Thread) (0x[0-9a-fA-F]+)", line)
        if m:
            current = {"ident": m.group(2),
                       "current": m.group(1) == "Current thread",
                       "frames": []}
            threads.append(current)
        elif current is not None and line.startswith("  "):
            current["frames"].append(line.strip())
    return {"fatal": fatal, "threads": threads, "raw": text}


def parse_native_journal(text: str) -> Optional[dict]:
    """Parse the C crash handler's spill: a ``tn-crash sig=N seq=M``
    header plus one ``j <seq> <op> <tid> <a> <b>`` line per ring
    entry, oldest first."""
    if not text.strip():
        return None
    out: dict = {"signal": None, "ops": []}
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "tn-crash":
            for kv in parts[1:]:
                k, _, v = kv.partition("=")
                if k == "sig" and v.lstrip("-").isdigit():
                    out["signal"] = int(v)
                elif k == "seq" and v.isdigit():
                    out["last_seq"] = int(v)
        elif parts[0] == "j" and len(parts) == 6:
            try:
                seq, op, tid, a, b = (int(x) for x in parts[1:])
            except ValueError:
                continue
            out["ops"].append({"seq": seq,
                               "op": NATIVE_OPS.get(op, f"op{op}"),
                               "tid": tid, "a": a, "b": b})
    out["ops"].sort(key=lambda e: e["seq"])
    return out


def assemble(directory: str, process_index: int = 0,
             events_tail: int = 256) -> dict:
    """Build the crash report dict from whatever artifacts the dead
    process left behind. Every section is best-effort: a report with
    holes beats no report."""
    def p(name: str) -> str:
        return artifact(directory, name, process_index)

    stacks = parse_stacks(_read_text(p(STACKS_TXT)))
    native = parse_native_journal(_read_text(p(NATIVE_JOURNAL_TXT)))
    signal = native["signal"] if native else None
    if signal is not None:
        cause = _SIGNAMES.get(signal, f"signal {signal}")
    elif stacks["fatal"]:
        cause = stacks["fatal"]
    else:
        # No fatal-signal evidence but no clean marker either:
        # SIGKILL / OOM-kill / exit without close. Still a report —
        # the ring tail and thread registry are the whole story then.
        cause = "died-without-fatal-signal"
    return {
        "version": REPORT_VERSION,
        "cause": cause,
        "signal": signal,
        "assembled_t": round(time.time(), 3),
        "process_index": process_index,
        "meta": _read_json(p(META_JSON)),
        "events": _ring.read_ring_file(p(EVENTS_RING), events_tail),
        "threads": _read_json(p(THREADS_JSON)),
        "stacks": stacks,
        "native_journal": native,
        "device_memory": _read_json(p(DEVICE_MEM_JSON)),
    }


def write_report(directory: str, process_index: int = 0) -> str:
    """Assemble and persist ``crash_report.json`` (torn-write-safe).
    Returns the report path."""
    report = assemble(directory, process_index)
    path = artifact(directory, REPORT_NAME, process_index)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)
    return path


def is_clean(directory: str, process_index: int = 0) -> bool:
    return os.path.exists(artifact(directory, CLEAN_MARKER,
                                   process_index))
