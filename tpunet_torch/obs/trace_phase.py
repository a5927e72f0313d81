"""Device time by training phase from a profiler trace: the port's
counterpart of ``tpunet/obs/trace_phase.py``.

The windowed profiler (``tpunet_torch/obs/spans.py``) writes a
``torch.profiler`` trace (``rank<r>.<time>.pt.trace.json``, Chrome's
trace format) under ``--profile-dir`` or ``<checkpoint-dir>/profile``.
The train and eval steps put tpunet's phase names around their work as
``record_function`` ranges (``tpunet_augment``, ``tpunet_fwd_bwd``,
``tpunet_optimizer``, ``tpunet_ema``, ``tpunet_eval_forward``), and this
module sums the card's time by phase, so a step-time regression names
the phase that moved instead of one opaque host lap:

- the work is the trace's device events: kernels, memcpys and memsets
  (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``). A trace of the
  CPU alone has none; its work is then the leaf CPU ops (ops with no op
  inside them on their thread), each at its own place;
- a device event belongs to the host call that launched it (the CUDA
  runtime event of the same ``correlation`` id), and that call to the
  innermost phase range around it on its thread;
- backward kernels are launched from the autograd engine's thread, not
  inside the main thread's ``tpunet_fwd_bwd`` range: a launch under an
  ``autograd::engine::evaluate_function`` event is ``bwd``, the rest of
  ``tpunet_fwd_bwd`` is ``fwd``;
- work that no range holds, or whose launch is not in the trace, is
  ``other``.

So the phases of a trace sum to its device time. ``phase_times`` keeps
tpunet's output: ``{phase: {"us", "pct"}}``, ordered by time. Consumers:
``python -m tpunet_torch.obs.cli.report --trace`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
from typing import Dict, List

PHASES = ("augment", "fwd", "bwd", "optimizer", "ema", "eval", "other")

# The record_function ranges of tpunet_torch/train/ and their phases.
RANGES = {"tpunet_augment": "augment", "tpunet_fwd_bwd": "fwd",
          "tpunet_optimizer": "optimizer", "tpunet_ema": "ema",
          "tpunet_eval_forward": "eval"}
BACKWARD = "autograd::engine::evaluate_function"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_files(trace_dir: str) -> List[str]:
    """The ``*.pt.trace.json`` files (gzipped too) under ``trace_dir``."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json.gz"),
                    recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir!r} "
                                "(did the profile window run?)")
    return paths


def load_events(path: str) -> List[dict]:
    """The complete events (``ph`` X) of one trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


class _Thread:
    """One host thread's phase ranges and backward spans, for the
    phase of an instant on it."""

    def __init__(self):
        self.ranges: List[tuple] = []     # (start, end, phase)
        self.bwd: List[tuple] = []        # (start, end)

    def freeze(self) -> None:
        self.ranges.sort()
        self.starts = [r[0] for r in self.ranges]
        merged: List[list] = []
        for s, e in sorted(self.bwd):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.bwd_starts = [m[0] for m in merged]
        self.bwd_ends = [m[1] for m in merged]

    def phase_at(self, ts: float) -> str:
        i = bisect.bisect_right(self.bwd_starts, ts) - 1
        if i >= 0 and ts <= self.bwd_ends[i]:
            return "bwd"
        # Ranges on one thread nest: the latest-starting range that
        # still holds ts is the innermost.
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            s, e, phase = self.ranges[i]
            if ts <= e:
                return phase
            i -= 1
        return "other"


def kernel_rows(events: List[dict]) -> List[dict]:
    """One row a unit of device work: ``{"name", "us", "phase"}``
    (module docstring)."""
    threads: Dict[tuple, _Thread] = {}

    def thread(e) -> _Thread:
        return threads.setdefault((e.get("pid"), e.get("tid")), _Thread())

    for e in events:
        name = e.get("name", "")
        if name in RANGES:
            thread(e).ranges.append((e["ts"], e["ts"] + e["dur"],
                                     RANGES[name]))
        elif name.startswith(BACKWARD):
            thread(e).bwd.append((e["ts"], e["ts"] + e["dur"]))
    for t in threads.values():
        t.freeze()
    empty = _Thread()
    empty.freeze()

    def phase_of(e) -> str:
        return threads.get((e.get("pid"), e.get("tid")), empty).phase_at(
            e["ts"])

    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if device:
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        rows = []
        for e in device:
            src = launch.get(e.get("args", {}).get("correlation"))
            rows.append({"name": e.get("name", ""), "us": float(e["dur"]),
                         "phase": "other" if src is None else phase_of(src)})
        return rows
    return [{"name": e.get("name", ""), "us": float(e["dur"]),
             "phase": phase_of(e)} for e in _leaf_ops(events)]


def _leaf_ops(events: List[dict]) -> List[dict]:
    """The CPU ops with no CPU op inside them on their thread."""
    by_thread: Dict[tuple, List[dict]] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    leaves = []
    for ops in by_thread.values():
        # Sorted by start, outer ops first: an op is a leaf when the next
        # op starts after it ends.
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        for a, b in zip(ops, ops[1:] + [None]):
            if b is None or b["ts"] >= a["ts"] + a["dur"]:
                leaves.append(a)
    return leaves


def trace_rows(trace_dir: str) -> List[dict]:
    """:func:`kernel_rows` of every trace under ``trace_dir``."""
    rows: List[dict] = []
    for path in trace_files(trace_dir):
        rows += kernel_rows(load_events(path))
    return rows


def device_total_us(rows: List[dict]) -> float:
    """The device time of ``rows``, every phase's."""
    return sum(r["us"] for r in rows)


def phase_times(rows: List[dict]) -> Dict[str, Dict[str, float]]:
    """Group measured device time by training phase.

    -> {phase: {"us": total time, "pct": share of profiled time}},
    phases ordered by time (tpunet's ``phase_times`` shape)."""
    by_phase: Dict[str, float] = {}
    for r in rows:
        if r["us"]:
            by_phase[r["phase"]] = by_phase.get(r["phase"], 0.0) + r["us"]
    total = sum(by_phase.values()) or 1.0
    return {ph: {"us": round(us, 1), "pct": round(100.0 * us / total, 2)}
            for ph, us in sorted(by_phase.items(), key=lambda kv: -kv[1])}
