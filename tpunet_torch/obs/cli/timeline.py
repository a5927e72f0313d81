"""Unified Perfetto timeline from one or more runs' flight recorders.

The port's copy of ``scripts/obs_timeline.py``: the same flags and the
same output, importing no JAX.

    # one training run -> trace.json (load at ui.perfetto.dev)
    python -m tpunet_torch.obs.cli.timeline checkpoints/ -o trace.json

    # trainer + serve replica on one clock
    python -m tpunet_torch.obs.cli.timeline train-run/ serve-run/ -o trace.json

    # router + N replicas, traces joined on trace_id into one track
    python -m tpunet_torch.obs.cli.timeline --metrics-dir router-run/ \\
        --metrics-dir rep-a/ --metrics-dir rep-b/ -o trace.json

Converts the crash-durable flightrec event rings (recorded by default
in every run: span begin/end pairs, host-thread busy/idle flips,
serve request lifecycles, alerts, epoch marks) into chrome-trace JSON
— host threads, device phases, and requests on one wall clock. Wire
details in docs/metrics_schema.md "Timeline export".

Exit: 0 written, 1 no rings found, 2 usage.
"""

from __future__ import annotations

import os
import sys

from tpunet_torch.obs.cli._flags import split_flags


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    # --metrics-dir is repeatable (router dir + N replica dirs in one
    # invocation -> single merged chrome-trace); split_flags is
    # last-wins so collect the repeats by hand first.
    dirs = []
    i = 0
    while i < len(args):
        if args[i] == "--metrics-dir":
            if i + 1 >= len(args):
                print("--metrics-dir needs a value", file=sys.stderr)
                return 2
            dirs.append(args[i + 1])
            del args[i:i + 2]
            continue
        i += 1
    parsed = split_flags(args, ("-o", "--out"))
    if isinstance(parsed, int):
        return parsed
    flags, paths = parsed
    paths = dirs + paths
    if not paths:
        print("usage: obs_timeline.py [--metrics-dir DIR]... RUN_DIR... "
              "[-o trace.json]", file=sys.stderr)
        return 2
    out = str(flags.get("o") or flags.get("out") or "trace.json")

    from tpunet_torch.obs.history import write_trace
    try:
        trace = write_trace(paths, out)
    except FileNotFoundError as e:
        print(f"obs_timeline: {e}", file=sys.stderr)
        return 1
    events = trace["traceEvents"]
    kinds = {"B": 0, "X": 0, "i": 0, "M": 0}
    for e in events:
        kinds[e["ph"]] = kinds.get(e["ph"], 0) + 1
    span_ms = 0.0
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    if ts:
        span_ms = (max(ts) - min(ts)) / 1e3
    print(f"obs_timeline: wrote {out}: {len(events)} events "
          f"({kinds.get('B', 0)} span pairs, {kinds.get('X', 0)} "
          f"complete, {kinds.get('i', 0)} instants) spanning "
          f"{span_ms:.1f} ms — open at ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
