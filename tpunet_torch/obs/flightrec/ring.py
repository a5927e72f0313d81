"""Crash-durable ring buffer of recent structured events.

The black-box half of the flight recorder: a fixed number of
fixed-size slots in a file-backed ``mmap``, so the last N events
survive ANY death mode — SIGSEGV, SIGABRT, even SIGKILL/OOM — with no
crash-time cooperation from the dying process (the page cache owns the
bytes the moment ``pack_into`` returns). Recording an event is one
atomic counter increment plus one 128-byte ``struct.pack_into`` into
mapped memory: ~1-2 us on the host, no syscalls, no locks, no flush —
cheap enough for span begin/end on the per-step path.

Lock-free discipline: the write cursor is an ``itertools.count``
(atomic under the GIL — ``__next__`` never releases it), so concurrent
recorders from any thread claim distinct slots; the only lossy race is
a writer lapped by a FULL ring rotation mid-pack, which corrupts one
slot's text payload at worst (readers decode with ``errors="replace"``
and drop slots whose seq is 0). Readers never coordinate with writers:
``tail()`` snapshots all slots, keeps the highest seqs, and sorts.

Stdlib-only ON PURPOSE: the post-mortem watcher process
(``watch.py``) parses this file without importing torch/numpy — keep it
that way. Dual-mode import (package or bare script) for the same
reason.
"""

from __future__ import annotations

import itertools
import mmap
import os
import struct
import threading
import time
from typing import List, Optional

MAGIC = b"TPFR1\x00"
HEADER = struct.Struct("<6sHII")           # magic, version, slot_size, n_slots
SLOT = struct.Struct("<QdQ16s80s")         # seq, wall_t, tid, kind, msg
SLOT_SIZE = SLOT.size                      # 120
VERSION = 1

DEFAULT_SLOTS = 1024


class EventRing:
    """Fixed-capacity event ring over a file-backed (or anonymous)
    mmap. ``path=None`` backs the ring with anonymous memory — same
    code path, nothing durable (unit tests, dir-less installs)."""

    def __init__(self, path: Optional[str] = None,
                 n_slots: int = DEFAULT_SLOTS):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.path = path
        self.n_slots = n_slots
        size = HEADER.size + n_slots * SLOT_SIZE
        if path:
            # O_TRUNC: one ring = one process incarnation (a resumed
            # run starts a fresh ring; the crash report it might need
            # was already assembled from the old one).
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC,
                         0o644)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        else:
            self._mm = mmap.mmap(-1, size)
        HEADER.pack_into(self._mm, 0, MAGIC, VERSION, SLOT_SIZE, n_slots)
        self._seq = itertools.count(1)     # 0 marks a never-written slot
        self._closed = False

    # -- write path ------------------------------------------------------

    def record(self, kind: str, msg: str = "") -> None:
        """Append one event. Never raises on the hot path: a recorder
        that can throw is a recorder nobody dares leave on."""
        try:
            seq = next(self._seq)
            off = HEADER.size + ((seq - 1) % self.n_slots) * SLOT_SIZE
            SLOT.pack_into(
                self._mm, off, seq, time.time(),
                threading.get_ident() & 0xFFFFFFFFFFFFFFFF,
                kind.encode("utf-8", "replace")[:16],
                msg.encode("utf-8", "replace")[:80])
        except (TypeError, ValueError, OSError):
            pass                            # closed/unmapped: drop

    # -- read path -------------------------------------------------------

    def tail(self, n: int = 0) -> List[dict]:
        """The last ``n`` events (all, when 0) in seq order."""
        return read_slots(self._mm, n)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass                            # a racing record holds a view


def _decode(raw: bytes) -> str:
    return raw.split(b"\x00", 1)[0].decode("utf-8", "replace")


def read_slots(buf: "bytes | mmap.mmap", n: int = 0) -> List[dict]:
    """Parse ring slots out of any buffer laid out by ``EventRing``
    (live mmap or a post-mortem file read). Torn/garbage slots are
    tolerated; unwritten ones (seq 0) are dropped."""
    try:
        magic, version, slot_size, n_slots = HEADER.unpack_from(buf, 0)
    except struct.error:
        return []
    if magic != MAGIC or slot_size != SLOT_SIZE:
        return []
    events = []
    for i in range(n_slots):
        off = HEADER.size + i * slot_size
        try:
            seq, t, tid, kind, msg = SLOT.unpack_from(buf, off)
        except struct.error:
            break
        if seq == 0:
            continue
        events.append({"seq": seq, "t": round(t, 6), "tid": tid,
                       "kind": _decode(kind), "msg": _decode(msg)})
    events.sort(key=lambda e: e["seq"])
    return events[-n:] if n else events


def read_ring_file(path: str, n: int = 0) -> List[dict]:
    """Post-mortem reader: parse a ring file left behind by a dead
    process."""
    try:
        with open(path, "rb") as f:
            return read_slots(f.read(), n)
    except OSError:
        return []
