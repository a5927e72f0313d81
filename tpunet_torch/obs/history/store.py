"""Run-history store: an append-only index of completed runs.

The paper's workload is a one-shot script with no memory of previous
runs; tpunet emits rich per-run telemetry (``metrics.jsonl``,
``BENCH_r*.json``) but nothing that remembers run N when run N+1
lands. This store closes that gap: ``ingest_run`` digests a finished
run directory into one bounded summary line, ``ingest_bench`` files a
bench artifact next to the training run that produced it (joined by
``run_id`` + config fingerprint — not by filename convention), and the
read side hands back the latest summary per run for the regression
compare (``tpunet_torch/obs/history/compare.py``) and the CLI
(``scripts/obs_compare.py``).

Storage discipline: one jsonl file (``history.jsonl``), append-only
with per-line flush — the same torn-line-tolerant format as
``metrics.jsonl``, read back through ``MetricsLogger.read_records``.
Re-ingesting a run appends a fresh line; readers resolve latest-wins
per ``(kind, run_id)``, so the index never needs rewriting and a crash
mid-append costs at most the last line.

Summaries are deterministic functions of the ingested records — no
wall-clock stamps — so ingesting the same run dir twice produces
byte-identical lines and downstream compare verdicts are reproducible
(the acceptance property the fixture tests pin).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from tpunet_torch.obs.agg import merge

INDEX_NAME = "history.jsonl"

#: Per-run bound on retained epoch windows (newest kept): enough for
#: any overlap alignment window, small enough that a summary line
#: stays a few tens of KB even with full 256-point samples.
EPOCH_WINDOWS_KEEP = 64
#: Same bound for retained serve windows.
SERVE_WINDOWS_KEEP = 64
#: Per-phase cap on retained trace samples: a deterministic stride
#: over the run's full sorted span population (the striding term of
#: ``merge.part_rank_error`` covers it — no reservoir randomness).
TRACE_SAMPLE_CAP = 256

#: The per-phase TTFT decomposition obs_trace replica-role spans
#: carry (docs/metrics_schema.md "obs_trace"): admission wait,
#: prefill device time, prefill-done -> first token out.
TRACE_PHASES = ("queue", "prefill", "first_decode")


def summarize_run(records: List[dict], source: str = "") -> dict:
    """One run's record stream -> the bounded summary the store files.

    Pure function of the records (no clock, no filesystem): throughput
    and MFU from the epoch rows, step-time quantiles merged from the
    exported rank-strided samples (``Histogram.export_sample``) with
    their DKW rank-error bound, serve TTFT/e2e SLO merges, and
    alert/crash counts.
    """
    summary: dict = {"kind": "run", "source": source}
    epochs = [r for r in records if r.get("kind") == "obs_epoch"]
    serves = [r for r in records if r.get("kind") == "obs_serve"]
    alerts = [r for r in records if r.get("kind") == "obs_alert"]
    crashes = [r for r in records if r.get("kind") == "obs_crash"]
    for r in records:
        for k in ("run_id", "config_fingerprint", "host"):
            if r.get(k) is not None:
                summary[k] = r[k]
    summary.setdefault("run_id", "")
    summary["records"] = len(records)

    windows = []
    for r in epochs:
        w = {"epoch": r.get("epoch"), "step": r.get("step"),
             "steps": int(r.get("steps") or 0)}
        if r.get("step_time_sample"):
            w["sample"] = r["step_time_sample"]
        if r.get("step_time_approx"):
            w["approx"] = 1
        for key in ("examples_per_sec", "tokens_per_sec", "mfu",
                    "step_time_p50_s"):
            if r.get(key) is not None:
                w[key] = r[key]
        windows.append(w)
    windows = windows[-EPOCH_WINDOWS_KEEP:]
    if windows:
        summary["epochs"] = len(epochs)
        summary["epoch_windows"] = windows
        summary["steps_total"] = sum(w["steps"] for w in windows)
        spans = [(w["step"] - w["steps"] + 1, w["step"])
                 for w in windows
                 if w.get("step") is not None and w["steps"] > 0]
        if spans:
            summary["step_lo"] = min(lo for lo, _ in spans)
            summary["step_hi"] = max(hi for _, hi in spans)
        last = epochs[-1]
        for key, unit in (("tokens_per_sec", "tokens"),
                          ("examples_per_sec", "examples")):
            if last.get(key) is not None:
                summary["throughput"] = last[key]
                summary["throughput_unit"] = unit
                vals = [w[key] for w in windows if w.get(key) is not None]
                if vals:
                    summary["throughput_mean"] = round(
                        sum(vals) / len(vals), 2)
                break
        if last.get("mfu") is not None:
            summary["mfu"] = last["mfu"]
        parts = merge.record_parts(
            [{"step_time_sample": w.get("sample"),
              "steps": w["steps"],
              "step_time_approx": w.get("approx")} for w in windows],
            "step_time_sample", "steps")
        if parts:
            merged = merge.merged_quantiles(parts, (50, 90, 99))
            summary["step_time_p50_s"] = round(merged[50], 6)
            summary["step_time_p90_s"] = round(merged[90], 6)
            summary["step_time_p99_s"] = round(merged[99], 6)
            summary["step_time_rank_err"] = round(
                merge.rank_error_bound(parts), 4)

    if serves:
        last = serves[-1]
        sv: dict = {"windows": len(serves)}
        for key in ("requests_total", "requests_completed",
                    "requests_rejected", "tokens_total", "slots"):
            if last.get(key) is not None:
                sv[key] = last[key]
        for key in ("ttft", "e2e"):
            parts = merge.record_parts(serves[-SERVE_WINDOWS_KEEP:],
                                       f"{key}_sample", f"{key}_count")
            if parts:
                merged = merge.merged_quantiles(parts, (50, 90, 99))
                sv[f"{key}_p50_s"] = round(merged[50], 6)
                sv[f"{key}_p90_s"] = round(merged[90], 6)
                sv[f"{key}_p99_s"] = round(merged[99], 6)
                sv[f"{key}_rank_err"] = round(
                    merge.rank_error_bound(parts), 4)
                sv[f"{key}_parts"] = [
                    [list(s), n, bool(sat)] for s, n, sat in parts]
        summary["serve"] = sv

    # Per-phase TTFT decomposition from replica-role trace spans:
    # where a regression LIVES (admission wait vs prefill vs first
    # decode), not just that TTFT moved. Spans are raw scalars per
    # record, so the part is built here: full sorted population,
    # stride-capped, count = true span count (compare.py merges it
    # through the same DKW machinery as step-time/serve samples).
    spans = [r for r in records if r.get("kind") == "obs_trace"
             and r.get("role") == "replica"]
    if spans:
        tr: dict = {"spans": len(spans)}
        for phase in TRACE_PHASES:
            vals = sorted(float(r[f"{phase}_s"]) for r in spans
                          if r.get(f"{phase}_s") is not None)
            if not vals:
                continue
            n = len(vals)
            if n > TRACE_SAMPLE_CAP:
                stride = n / TRACE_SAMPLE_CAP
                vals = [vals[min(n - 1, int(i * stride))]
                        for i in range(TRACE_SAMPLE_CAP)]
            parts = [(vals, n, False)]
            merged = merge.merged_quantiles(parts, (50, 90, 99))
            tr[f"{phase}_p50_s"] = round(merged[50], 6)
            tr[f"{phase}_p90_s"] = round(merged[90], 6)
            tr[f"{phase}_p99_s"] = round(merged[99], 6)
            tr[f"{phase}_rank_err"] = round(
                merge.rank_error_bound(parts), 4)
            tr[f"{phase}_parts"] = [
                [list(s), cnt, bool(sat)] for s, cnt, sat in parts]
        summary["trace"] = tr

    if alerts:
        by_reason: Dict[str, int] = {}
        for a in alerts:
            r = str(a.get("reason", "unknown"))
            by_reason[r] = by_reason.get(r, 0) + 1
        summary["alerts"] = len(alerts)
        summary["alerts_by_reason"] = dict(sorted(by_reason.items()))
    if crashes:
        summary["crashes"] = len(crashes)
    return summary


def bench_entry(record: dict, source: str = "") -> dict:
    """A BENCH artifact -> its index line. Accepts both the raw
    bench.py record and the driver-style wrapper (``{"parsed": ...}``)
    the checked-in ``BENCH_r*.json`` files use."""
    if isinstance(record.get("parsed"), dict):
        record = record["parsed"]
    entry: dict = {"kind": "bench", "source": source}
    for key in ("run_id", "config_fingerprint", "metric", "value",
                "unit", "device_kind", "mfu", "pct_of_roofline",
                "roofline_bytes_per_image", "model_overrides"):
        if record.get(key) is not None:
            entry[key] = record[key]
    entry.setdefault("run_id", "")
    return entry


class RunHistory:
    """Append-only run index under one directory.

    Readers tolerate the torn trailing line; writers append one
    flushed line per ingest. Latest line wins per ``(kind, run_id)``
    — ingesting a run again (more epochs landed) simply supersedes
    the earlier summary.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, INDEX_NAME)

    # -- write side ------------------------------------------------------

    def _append(self, entry: dict) -> dict:
        os.makedirs(self.directory, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        return entry

    def ingest_run(self, run_dir: str) -> dict:
        """Digest ``<run_dir>/metrics.jsonl`` into one summary line.
        Raises FileNotFoundError when the run dir has no metrics."""
        path = os.path.join(run_dir, "metrics.jsonl")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"no metrics.jsonl under {run_dir!r} — not a completed "
                "run directory")
        from tpunet_torch.utils.logging import MetricsLogger
        records = MetricsLogger.read_records(path)
        return self._append(summarize_run(records, source=run_dir))

    def ingest_bench(self, path: str) -> dict:
        """File one ``BENCH_r*.json`` (or raw bench.py stdout record)
        under its ``run_id`` + ``config_fingerprint``."""
        with open(path) as f:
            record = json.load(f)
        return self._append(bench_entry(record, source=path))

    # -- read side -------------------------------------------------------

    def entries(self, kind: Optional[str] = None) -> List[dict]:
        """Every index line in append order (optionally one kind)."""
        if not os.path.isfile(self.path):
            return []
        from tpunet_torch.utils.logging import MetricsLogger
        out = MetricsLogger.read_records(self.path)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out

    def runs(self, fingerprint: Optional[str] = None) -> List[dict]:
        """Latest summary per run_id (append order preserved),
        optionally restricted to one config fingerprint."""
        latest: Dict[str, dict] = {}
        for e in self.entries("run"):
            latest[str(e.get("run_id") or e.get("source"))] = e
        out = list(latest.values())
        if fingerprint is not None:
            out = [e for e in out
                   if e.get("config_fingerprint") == fingerprint]
        return out

    def run(self, run_id: str) -> Optional[dict]:
        """Latest summary for one run_id (or a run-dir source path)."""
        for e in reversed(self.entries("run")):
            if e.get("run_id") == run_id or e.get("source") == run_id:
                return e
        return None

    def bench_for(self, run: dict) -> List[dict]:
        """Bench entries joined to a run summary: by run_id when both
        sides carry one, else by config fingerprint."""
        rid = run.get("run_id")
        fp = run.get("config_fingerprint")
        out = []
        for e in self.entries("bench"):
            if rid and e.get("run_id") == rid:
                out.append(e)
            elif fp and e.get("config_fingerprint") == fp \
                    and not e.get("run_id"):
                out.append(e)
        return out
