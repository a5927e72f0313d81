"""Reading a ``torch.profiler`` trace of the traced steps.

The attribution of device work to training phases is a frozen copy of
the port's (``obs/trace_phase.py``), so that the yardstick stays put
when the program changes:

- the work is the trace's device events: kernels, copies and fills;
- a device event belongs to the host call that launched it (the CUDA
  runtime event of the same ``correlation`` id), and that call to the
  innermost phase range around it on its thread (the training step's
  ``tpunet_augment``, ``tpunet_fwd_bwd``, ``tpunet_optimizer`` ranges);
- a launch under an ``autograd::engine::evaluate_function`` event is
  ``bwd`` (the backward runs on the autograd engine's thread), the rest
  of ``tpunet_fwd_bwd`` is ``fwd``; work no range holds is ``other``.

:func:`summary` reduces one trace to what the per-layer metrics read:
device time by phase and by kernel name, the busy time (the union of the
device events), and the longest idle gaps by what the host was doing:
the innermost host op covering the gap's start, under the harness's own
span (``portbench.data_wait`` or ``portbench.train_step``).
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Tuple

RANGES = {"tpunet_augment": "augment", "tpunet_fwd_bwd": "fwd",
          "tpunet_optimizer": "optimizer", "tpunet_ema": "ema",
          "tpunet_eval_forward": "eval"}
BACKWARD = "autograd::engine::evaluate_function"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPANS = ("portbench.data_wait", "portbench.train_step")
TOP = 10


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


class _Thread:
    def __init__(self):
        self.ranges: List[tuple] = []
        self.bwd: List[tuple] = []

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
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            s, e, phase = self.ranges[i]
            if ts <= e:
                return phase
            i -= 1
        return "other"


def device_rows(events: List[dict]) -> List[dict]:
    """One row a device event: name, start, duration (us), phase."""
    threads: Dict[tuple, _Thread] = {}
    for e in events:
        name = e.get("name", "")
        if name in RANGES:
            threads.setdefault((e.get("pid"), e.get("tid")), _Thread()
                               ).ranges.append((e["ts"], e["ts"] + e["dur"],
                                                RANGES[name]))
        elif name.startswith(BACKWARD):
            threads.setdefault((e.get("pid"), e.get("tid")), _Thread()
                               ).bwd.append((e["ts"], e["ts"] + e["dur"]))
    for t in threads.values():
        t.freeze()
    empty = _Thread()
    empty.freeze()
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    rows = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        src = launch.get(e.get("args", {}).get("correlation"))
        phase = "other" if src is None else threads.get(
            (src.get("pid"), src.get("tid")), empty).phase_at(src["ts"])
        rows.append({"name": e.get("name", ""), "ts": float(e["ts"]),
                     "us": float(e["dur"]), "phase": phase})
    return rows


def busy_intervals(rows: List[dict]) -> List[Tuple[float, float]]:
    merged: List[list] = []
    for s, e in sorted((r["ts"], r["ts"] + r["us"]) for r in rows):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


SHORT_GAP_US = 10.0     # gaps shorter than this are one kernel to the next
SCAN = 256              # host ops scanned back for the innermost one


def _covering(events: List[dict], starts: List[float], ts: float,
              scan: int) -> List[dict]:
    i = bisect.bisect_right(starts, ts) - 1
    return [e for e in events[max(0, i - scan):i + 1]
            if e["ts"] + e["dur"] >= ts]


def _host_label(spans, span_starts, ops, op_starts, ts: float) -> str:
    """The harness span and the innermost host op holding ``ts``."""
    held = _covering(spans, span_starts, ts, 4)
    span = held[-1]["name"] if held else "outside the steps"
    inner = min(_covering(ops, op_starts, ts, SCAN), key=lambda e: e["dur"],
                default=None)
    return f"{span}: {inner['name']}" if inner else span


def summary(path: str) -> dict:
    """What the per-layer metrics read from one rank's trace."""
    events = load_events(path)
    rows = device_rows(events)
    by_phase: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for r in rows:
        by_phase[r["phase"]] = by_phase.get(r["phase"], 0.0) + r["us"]
        by_name[r["name"]] = by_name.get(r["name"], 0.0) + r["us"]
    busy = busy_intervals(rows)
    host = sorted((e for e in events if e.get("cat") in ("cpu_op",
                                                         "user_annotation")),
                  key=lambda e: e["ts"])
    spans = [e for e in host if e["name"] in SPANS]
    ops = [e for e in host if e["name"] not in SPANS]
    span_starts, op_starts = [e["ts"] for e in spans], [e["ts"] for e in ops]
    gaps: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        label = (f"kernel to kernel (< {SHORT_GAP_US:g} us)"
                 if nxt - end < SHORT_GAP_US else
                 _host_label(spans, span_starts, ops, op_starts, end))
        gaps[label] = gaps.get(label, 0.0) + (nxt - end)
    return {
        "phase_us": by_phase,
        "kernel_us": by_name,
        "busy_us": sum(e - s for s, e in busy),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
    }
