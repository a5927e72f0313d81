"""ctypes bindings for the native host-side batch assembler, a copy of
``tpunet/data/native.py`` over the unchanged ``cxx/batcher.cc``.

tpunet's device-side augmentation leaves only a permutation gather on
the host, which this C++ library does with threads in-process and
prefetches ahead of the device. The library is built with ``g++`` at
first use (never on import) into
``build/tpunet_torch/libtnbatcher-<hash>.so``, the hash of the source
and the flags in the name, so an edited source is rebuilt. Where no C++
compiler can build it, :func:`available` is False and callers take the
numpy loader, which gives the same batches.

The surface is tpunet's: :func:`available`, :func:`gather_rows`,
:class:`NativePrefetcher`, the flight recorder's :func:`journal_entries`
and :func:`crash_install`, and the ``_ABI_VERSION`` check.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "cxx" / "batcher.cc"
_BUILD_DIR = _REPO / "build" / "tpunet_torch"
_CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Werror=return-type",
              "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


# Must match tn_abi_version() in cxx/batcher.cc; bump both together.
# v2: flight-recorder surface (tn_journal_read / tn_crash_install).
_ABI_VERSION = 2


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return _BUILD_DIR / f"libtnbatcher-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile to a private temp file and rename it into place: atomic,
    so concurrent processes never load a partly written library."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS, str(_SRC), "-o",
           str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _SRC.exists():
            _load_failed = True
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        # Refuse a library whose C ABI doesn't match these bindings.
        try:
            lib.tn_abi_version.restype = ctypes.c_int
            abi = lib.tn_abi_version()
        except AttributeError:
            abi = -1
        if abi != _ABI_VERSION:
            _load_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tn_gather_rows.argtypes = [u8p, i64p, ctypes.c_int64,
                                       ctypes.c_int64, u8p, ctypes.c_int]
        lib.tn_gather_rows.restype = None
        lib.tn_prefetcher_create.argtypes = [u8p, i32p, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int, ctypes.c_int]
        lib.tn_prefetcher_create.restype = ctypes.c_void_p
        lib.tn_prefetcher_start_epoch.argtypes = [ctypes.c_void_p, i64p,
                                                  ctypes.c_int64]
        lib.tn_prefetcher_start_epoch.restype = ctypes.c_int
        lib.tn_prefetcher_next.argtypes = [ctypes.c_void_p, u8p, i32p]
        lib.tn_prefetcher_next.restype = ctypes.c_int
        lib.tn_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.tn_prefetcher_destroy.restype = None
        lib.tn_journal_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tn_journal_read.restype = ctypes.c_int
        lib.tn_crash_install.argtypes = [ctypes.c_char_p]
        lib.tn_crash_install.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Flight-recorder surface (tpunet_torch/obs/flightrec/): the native op
# journal and the C-level crash spill.
# ---------------------------------------------------------------------------


class _JournalEntry(ctypes.Structure):
    # Mirrors JournalEntry in cxx/batcher.cc (packed 32 bytes).
    _fields_ = [("seq", ctypes.c_uint64), ("op", ctypes.c_uint32),
                ("tid", ctypes.c_uint32), ("a", ctypes.c_int64),
                ("b", ctypes.c_int64)]


def journal_entries(max_entries: int = 256) -> list:
    """Live snapshot of the native op journal (oldest-first dicts with
    op names), or [] when the library is unavailable."""
    lib = _load()
    if lib is None:
        return []
    buf = (_JournalEntry * max_entries)()
    n = lib.tn_journal_read(buf, max_entries)
    from tpunet_torch.obs.flightrec.report import NATIVE_OPS
    return [{"seq": int(e.seq),
             "op": NATIVE_OPS.get(int(e.op), f"op{int(e.op)}"),
             "tid": int(e.tid), "a": int(e.a), "b": int(e.b)}
            for e in buf[:max(0, n)]]


def crash_install(path: str) -> bool:
    """Arm the C crash handler: on SIGSEGV/SIGABRT/SIGBUS it spills
    the op journal to ``path`` and chains to the previously installed
    handler (call AFTER faulthandler.enable so Python stacks still
    dump). False when the library is unavailable or sigaction
    failed."""
    lib = _load()
    if lib is None:
        return False
    return lib.tn_crash_install(os.fsencode(path)) == 0


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather_rows(src: np.ndarray, idx: np.ndarray,
                n_threads: int = 4) -> np.ndarray:
    """out[i] = src[idx[i]] over the leading axis, for any fixed-size
    dtype (the C++ gather is a raw byte memcpy per row), multithreaded
    when the library is available, else numpy fancy indexing — bit-equal
    either way."""
    lib = _load()
    src = np.ascontiguousarray(src)
    if lib is None:
        return src[idx]
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    row_bytes = int(np.prod(src.shape[1:], dtype=np.int64)) * src.itemsize
    lib.tn_gather_rows(_as_u8p(src), _as_i64p(idx), len(idx), row_bytes,
                       _as_u8p(out), n_threads)
    return out


class NativePrefetcher:
    """Background-thread batch assembly over an in-RAM dataset of any
    fixed-size dtype (uint8 image rows, int32 token rows). Holds
    ``rows``/``labels`` for its lifetime: the C++ side reads their
    buffers directly."""

    def __init__(self, rows: np.ndarray, labels: np.ndarray,
                 local_batch: int, depth: int = 4, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native batcher unavailable")
        self._lib = lib
        self.rows = np.ascontiguousarray(rows)
        self.labels = np.ascontiguousarray(labels, dtype=np.int32)
        self.local_batch = int(local_batch)
        self.row_shape = self.rows.shape[1:]
        self.row_dtype = self.rows.dtype
        row_bytes = (int(np.prod(self.row_shape, dtype=np.int64))
                     * self.rows.itemsize)
        self._handle = lib.tn_prefetcher_create(
            _as_u8p(self.rows), _as_i32p(self.labels), len(self.rows),
            row_bytes, self.local_batch, depth, n_threads)
        self._idx: Optional[np.ndarray] = None   # kept alive for C++ reads
        # Host-thread registry: the C++ worker cannot beat from its own
        # thread, so the consumer beats for it — "busy" before it blocks
        # in next(), and a consumer stuck there past the budget is the
        # hang the thread_stalled alert pages (the C journal then says
        # what the worker was doing).
        from tpunet_torch.obs import flightrec
        self._fr = flightrec
        self._thread = flightrec.register_thread("native-prefetcher",
                                                 stall_after_s=120.0)

    def iter_epoch(self, idx: np.ndarray) -> Iterator[
            Tuple[np.ndarray, np.ndarray]]:
        """Yield (rows[local_batch, ...], labels int32) following ``idx``."""
        self._idx = np.ascontiguousarray(idx, dtype=np.int64)
        self._fr.record("prefetch", f"epoch start n={len(idx)}")
        if self._lib.tn_prefetcher_start_epoch(
                self._handle, _as_i64p(self._idx), len(self._idx)):
            raise IndexError("prefetcher index out of range for dataset")
        while True:
            x = np.empty((self.local_batch,) + self.row_shape,
                         self.row_dtype)
            y = np.empty((self.local_batch,), np.int32)
            self._thread.beat("busy")    # about to block in next()
            done = self._lib.tn_prefetcher_next(self._handle, _as_u8p(x),
                                                _as_i32p(y))
            self._thread.beat("idle")
            if done:
                self._fr.record("prefetch", "epoch exhausted")
                return
            yield x, y

    def close(self) -> None:
        if self._handle:
            self._fr.record("prefetch", "destroy")
            self._lib.tn_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
