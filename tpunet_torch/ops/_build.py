"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every ``tpunet_torch/csrc/<name>.cu`` is compiled at first use into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/tpunet_torch/lib<name>-<hash>.so <name>.cu

The library's file name carries a hash of the source, of every shared
header ``csrc/*.cuh`` and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. A header is never built
on its own.
ptxas's report of each kernel's registers and spills is kept beside the
library (``lib<name>-<hash>.ptxas.txt``) and read by :func:`resources`.
The source includes no PyTorch header, which keeps a build to seconds.
A failed build or load raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpunet_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/`` (``depthwise`` for
    ``csrc/depthwise.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> None:
    """nvcc ``csrc/<name>.cu`` into a temporary file, then rename it into
    place: a concurrent build of the same source writes an identical
    file, and a reader never sees a partial one."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    out = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {out.returncode}):\n{out.stdout}")
    library_path(name).with_suffix(".ptxas.txt").write_text(out.stdout)
    os.replace(tmp, library_path(name))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            _build(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        lib = _loaded.setdefault(name, lib)
    return lib


def build_all() -> List[str]:
    """Build and load every source under ``csrc/``, one nvcc process per
    source, all running at once; returns the names."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(load, names))
    return names


def resources(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu`` (by mangled name), the registers a
    thread and the spill stores and loads in bytes, from ptxas's report
    of its build; empty before the library is built."""
    log = library_path(name).with_suffix(".ptxas.txt")
    found: Dict[str, Dict[str, int]] = {}
    if not log.exists():
        return found
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = found.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return found
