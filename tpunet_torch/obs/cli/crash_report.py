"""Render a flight-recorder crash report for humans.

The port's copy of ``scripts/obs_crash_report.py``: the same flags and
the same output, over ``tpunet_torch.obs.flightrec.report``, importing
no JAX, so the card's host reads the reports of its own runs.

The watcher (tpunet_torch/obs/flightrec/watch.py) leaves
``<run-dir>/flightrec/crash_report.json`` when a run dies; this module
turns it into the post-mortem narrative: what killed the process,
what every thread was doing, the last events before death, and the
native batcher journal. It can also assemble a report directly from a
flightrec artifact dir (``--assemble``) when the watcher never got the
chance (e.g. the artifacts were copied off a dead host).

    python -m tpunet_torch.obs.cli.crash_report <run-dir | report.json>
    python -m tpunet_torch.obs.cli.crash_report --json <...>     # raw report
    python -m tpunet_torch.obs.cli.crash_report --assemble <flightrec-dir>
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from tpunet_torch.obs.flightrec import report as frreport


def find_report(path: str) -> str:
    """Resolve a run dir / flightrec dir / report file to a report
    path (the live report if present, else the newest archive)."""
    if os.path.isfile(path):
        return path
    candidates = []
    for base in (path, os.path.join(path, "flightrec")):
        if not os.path.isdir(base):
            continue
        live = os.path.join(base, frreport.REPORT_NAME)
        if os.path.isfile(live):
            return live
        candidates += glob.glob(os.path.join(base, "crash_report.*.json"))
    if not candidates:
        raise FileNotFoundError(
            f"no crash_report*.json under {path!r} (is this a run dir "
            "with a flightrec/ subdir?)")
    return max(candidates, key=os.path.getmtime)


def _t(ts) -> str:
    if not ts:
        return "?"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


def render(rep: dict, path: str, events_tail: int = 40) -> str:
    out = [f"tpunet crash report — {path}", ""]
    meta = rep.get("meta") or {}
    out.append(f"cause: {rep.get('cause', '?')}"
               + (f" (signal {rep['signal']})"
                  if rep.get("signal") is not None else ""))
    out.append(f"pid {meta.get('pid', '?')}  started {_t(meta.get('started_t'))}"
               f"  assembled {_t(rep.get('assembled_t'))}")
    if meta.get("argv"):
        out.append("argv: " + " ".join(meta["argv"]))
    if meta.get("run_id"):
        out.append(f"run_id: {meta['run_id']}  "
                   f"process_index: {meta.get('process_index', 0)}")
    out.append("")

    threads = rep.get("threads") or []
    if threads:
        out.append(f"HOST THREADS ({len(threads)} registered, last "
                   "epoch-boundary snapshot):")
        for t in threads:
            out.append(f"  {t.get('name', '?'):<22} {t.get('state', '?'):<5} "
                       f"age {t.get('age_s', '?')}s  "
                       f"beats {t.get('beats', '?')}")
        out.append("")

    stacks = rep.get("stacks") or {}
    sthreads = stacks.get("threads") or []
    if sthreads:
        out.append(f"PYTHON STACKS AT DEATH ({len(sthreads)} threads):")
        for t in sthreads:
            tag = "current " if t.get("current") else ""
            out.append(f"  {tag}thread {t.get('ident', '?')}:")
            for frame in t.get("frames", [])[:12]:
                out.append(f"    {frame}")
        out.append("")

    events = rep.get("events") or []
    if events:
        out.append(f"EVENT RING TAIL (last {min(events_tail, len(events))}"
                   f" of {len(events)} captured):")
        for ev in events[-events_tail:]:
            out.append(f"  {ev.get('seq', '?'):>6} {_t(ev.get('t'))} "
                       f"[{ev.get('kind', '?'):<9}] {ev.get('msg', '')}")
        out.append("")

    nj = rep.get("native_journal")
    if nj:
        ops = nj.get("ops") or []
        out.append(f"NATIVE BATCHER JOURNAL ({len(ops)} ops, oldest "
                   "first):")
        for op in ops[-40:]:
            out.append(f"  {op.get('seq', '?'):>6} "
                       f"{op.get('op', '?'):<14} a={op.get('a')} "
                       f"b={op.get('b')} tid={op.get('tid')}")
        out.append("")

    mem = rep.get("device_memory")
    if mem:
        out.append(f"DEVICE MEMORY (last sampled "
                   f"{_t(mem.get('sampled_t'))}):")
        for d in mem.get("devices") or []:
            if not isinstance(d, dict):
                continue
            used = d.get("bytes_in_use")
            out.append(f"  device {d.get('device', '?')}: "
                       + (f"{used / 2**20:.1f} MiB in use, peak "
                          f"{(d.get('peak_bytes_in_use') or 0) / 2**20:.1f}"
                          " MiB" if used is not None else "(no stats)"))
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpunet_torch.obs.cli.crash_report",
        description=__doc__.splitlines()[0])
    ap.add_argument("path", help="run dir, flightrec dir, or a "
                                 "crash_report*.json")
    ap.add_argument("--json", action="store_true",
                    help="print the raw report JSON")
    ap.add_argument("--assemble", action="store_true",
                    help="(re)assemble the report from a flightrec "
                         "artifact dir before rendering")
    ap.add_argument("--events", type=int, default=40,
                    help="event-ring tail lines to show")
    args = ap.parse_args(argv)
    if args.assemble:
        d = args.path
        if os.path.isdir(os.path.join(d, "flightrec")):
            d = os.path.join(d, "flightrec")
        path = frreport.write_report(d)
    else:
        path = find_report(args.path)
    with open(path) as f:
        rep = json.load(f)
    if args.json:
        json.dump(rep, sys.stdout, indent=1)
        print()
    else:
        print(render(rep, path, events_tail=args.events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
