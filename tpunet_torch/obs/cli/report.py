"""Summarize a run's ``metrics.jsonl`` (tpunet/obs/ record schema).

The port's copy of ``scripts/obs_report.py``: the same flags and the same
output, importing no JAX, so the card's host reads a run with it.

Usage:
    python -m tpunet_torch.obs.cli.report checkpoints/metrics.jsonl
    python -m tpunet_torch.obs.cli.report checkpoints/   # finds metrics.jsonl
    python -m tpunet_torch.obs.cli.report checkpoints/ --json
    python -m tpunet_torch.obs.cli.report checkpoints/ \\
        --trace checkpoints/profile

Prints the per-epoch training table, the step-time percentile /
input-stall summary from the ``obs_epoch`` records, the per-window
``obs_step`` step-time trend, any ``obs_alert`` records, and
device-memory high-water marks. ``--json`` emits the same summary as
one JSON object (the ``tpunet_torch.obs.summary.summarize`` schema).
Tolerates a truncated trailing line (a crashed or preempted run's
artifact) via ``MetricsLogger.read_records``.

``--trace DIR`` additionally attributes MEASURED device time to
training phases (augment / fwd / bwd / optimizer / ema / eval) from the
windowed profiler's ``torch.profiler`` traces under DIR
(``--profile-dir``, or ``<checkpoint-dir>/profile``, found by itself
next to a run directory's ``metrics.jsonl``), through
``tpunet_torch.obs.trace_phase`` — so a step-time regression names the
phase that moved instead of one opaque host lap.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _fmt_s(v, digits=4):
    return "-" if v is None else f"{v:.{digits}f}"


def _fmt_ms(v):
    return "-" if v is None else f"{v * 1e3:.1f}"


def render(summary: dict) -> list:
    """Text report lines from a ``summarize()`` dict."""
    epochs = summary["epochs"]
    obs = summary["obs_epochs"]
    windows = summary["step_windows"]
    alerts = summary["alerts"]
    totals = summary["totals"]
    lines = []

    if epochs:
        lines.append("== epochs ==")
        lines.append(f"{'ep':>4} {'secs':>8} {'train_loss':>10} "
                     f"{'train_acc':>9} {'test_loss':>9} {'test_acc':>8} "
                     f"{'thruput':>10}")
        for r in epochs:
            thr = r.get("examples_per_sec", r.get("tokens_per_sec"))
            lines.append(
                f"{r['epoch']:>4} {_fmt_s(r.get('seconds'), 2):>8} "
                f"{_fmt_s(r.get('train_loss')):>10} "
                f"{_fmt_s(r.get('train_accuracy')):>9} "
                f"{_fmt_s(r.get('test_loss')):>9} "
                f"{_fmt_s(r.get('test_accuracy')):>8} "
                f"{_fmt_s(thr, 1):>10}"
                + ("  [partial]" if r.get("partial") else ""))

    if obs:
        lines.append("")
        lines.append("== step time / stalls (obs_epoch) ==")
        lines.append(f"{'ep':>4} {'steps':>6} {'p50ms':>8} {'p90ms':>8} "
                     f"{'p99ms':>8} {'stall_s':>8} {'stall%':>7} "
                     f"{'mfu':>6} {'procs':>6}")
        for r in obs:
            lines.append(
                f"{r['epoch']:>4} {r.get('steps', 0):>6} "
                f"{_fmt_ms(r.get('step_time_p50_s')):>8} "
                f"{_fmt_ms(r.get('step_time_p90_s')):>8} "
                f"{_fmt_ms(r.get('step_time_p99_s')):>8} "
                f"{_fmt_s(r.get('input_stall_s'), 2):>8} "
                f"{100 * r.get('stall_frac', 0.0):>6.1f}% "
                f"{_fmt_s(r.get('mfu'), 3):>6} "
                f"{r.get('live_processes', 1):>6}")
        frac = totals.get("stall_frac", 0.0)
        lines.append(f"run input-stall: "
                     f"{totals.get('input_stall_s', 0.0):.2f}s of "
                     f"{totals.get('train_seconds', 0.0):.2f}s train "
                     f"time ({100 * frac:.1f}%)")
        peak = totals.get("peak_bytes_in_use")
        if peak is not None:
            lines.append(f"device memory high-water: "
                         f"{peak / 2**30:.2f} GiB")
        else:
            lines.append("device memory: backend reports no allocator "
                         "stats (CPU)")

    if windows:
        lines.append("")
        lines.append("== step-time trend (obs_step windows) ==")
        lines.append(f"{'steps':>15} {'n':>5} {'mean_ms':>8} "
                     f"{'p50ms':>8} {'p99ms':>8} {'wait_ms':>8}")
        for w in windows:
            span = f"{w['step_lo']}-{w['step_hi']}"
            lines.append(
                f"{span:>15} {w['samples']:>5} "
                f"{_fmt_ms(w['step_time_mean_s']):>8} "
                f"{_fmt_ms(w['step_time_p50_s']):>8} "
                f"{_fmt_ms(w['step_time_p99_s']):>8} "
                f"{_fmt_ms(w['data_wait_mean_s']):>8}")

    if alerts:
        lines.append("")
        lines.append(f"== alerts ({len(alerts)}) ==")
        for a in alerts:
            extras = {k: v for k, v in a.items()
                      if k not in ("kind", "reason", "step", "severity")}
            lines.append(f"  step {a.get('step', '?'):>8} "
                         f"[{a.get('severity', 'warn')}] "
                         f"{a.get('reason', '?')} {extras}")

    if not lines:
        lines.append("no records found")
    return lines


def render_phases(phases: dict) -> list:
    """Text lines for a ``trace_phase.phase_times`` dict."""
    lines = ["", "== device time by phase (profiled window) =="]
    lines.append(f"{'phase':>10} {'ms/window':>12} {'share':>7}")
    for ph, row in phases.items():
        lines.append(f"{ph:>10} {row['us'] / 1e3:>12.2f} "
                     f"{row['pct']:>6.1f}%")
    return lines


def device_phases(trace_dir: str):
    """-> (phases dict or None, note lines). Degrades to a note when the
    trace is unavailable."""
    from tpunet_torch.obs.trace_phase import phase_times, trace_rows
    try:
        return phase_times(trace_rows(trace_dir)), []
    except Exception as e:  # no trace / unreadable trace
        return None, ["", f"device-phase attribution unavailable: {e}"]


def report(records: list, trace_dir: str = None) -> list:
    """Build the report lines from parsed metrics.jsonl records."""
    from tpunet_torch.obs.summary import summarize
    lines = render(summarize(records))
    if trace_dir:
        phases, notes = device_phases(trace_dir)
        lines += render_phases(phases) if phases else notes
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpunet_torch.obs.cli.report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("path", help="metrics.jsonl, or a directory "
                                 "containing one (e.g. checkpoints/)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable summary (the "
                         "tpunet_torch.obs.summary.summarize schema) instead "
                         "of the text tables")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profiler trace dir (--profile-dir or "
                         "<checkpoint-dir>/profile): adds measured "
                         "device time by phase (fwd/bwd/optimizer/"
                         "ema/eval) from its torch.profiler traces")
    args = ap.parse_args(argv)
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
        if args.trace is None:
            # Convention: the windowed profiler writes under
            # <checkpoint-dir>/profile when --profile-dir is unset.
            cand = os.path.join(os.path.dirname(path), "profile")
            if os.path.isdir(cand):
                args.trace = cand
    if not os.path.isfile(path):
        print(f"no metrics.jsonl at {path}", file=sys.stderr)
        return 1
    from tpunet_torch.utils.logging import MetricsLogger
    records = MetricsLogger.read_records(path)
    if args.json:
        from tpunet_torch.obs.summary import summarize
        out = summarize(records)
        if args.trace:
            phases, _notes = device_phases(args.trace)
            out["device_phases"] = phases
        print(json.dumps(out, indent=2))
        return 0
    for line in report(records, trace_dir=args.trace):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
