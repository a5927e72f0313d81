"""One summarizer for every metrics.jsonl consumer.

A copy of ``tpunet/obs/summary.py`` (framework-free), so the summary
runs where the port runs, with no JAX installed.

``scripts/obs_report.py`` (post-mortem), ``scripts/obs_dashboard.py``
(live) and any ``--json`` machine consumer all read the same record
stream; this module turns parsed records into one structured summary
dict so the three views can never drift on what "stall fraction" or
"step-time trend" means. Record kinds are documented in
``docs/metrics_schema.md``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpunet_torch.obs.registry import percentile_of_sorted


def _percentile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    return percentile_of_sorted(sorted(xs), q)


def step_windows(steps: List[dict], n_windows: int = 12) -> List[Dict]:
    """Bucket ``obs_step`` records into up to ``n_windows`` contiguous
    step-range windows and summarize each — the step-time *trend* view
    (is the run slowing down? did stalls start at step 40k?) that a
    single whole-run percentile hides."""
    times = [(r["step"], r["step_time_s"], r.get("data_wait_s", 0.0))
             for r in steps if "step_time_s" in r]
    if not times:
        return []
    times.sort(key=lambda t: t[0])
    per = max(1, -(-len(times) // n_windows))  # ceil division
    out = []
    for i in range(0, len(times), per):
        chunk = times[i:i + per]
        laps = [t[1] for t in chunk]
        waits = [t[2] for t in chunk]
        out.append({
            "step_lo": chunk[0][0],
            "step_hi": chunk[-1][0],
            "samples": len(chunk),
            "step_time_mean_s": sum(laps) / len(laps),
            "step_time_p50_s": _percentile(laps, 50),
            "step_time_p99_s": _percentile(laps, 99),
            "data_wait_mean_s": sum(waits) / len(waits),
        })
    return out


def summarize(records: List[dict], n_windows: int = 12) -> Dict:
    """Structured summary of a run's metrics.jsonl records.

    Returns ``{epochs, obs_epochs, step_windows, alerts, totals}``:
    the raw per-epoch rows (plain training records and ``obs_epoch``
    records), the bucketed ``obs_step`` trend, every ``obs_alert``,
    and run-level aggregates (stall fraction, memory high-water, last
    throughput/MFU).
    """
    epochs = [r for r in records if "kind" not in r and "epoch" in r]
    obs = [r for r in records if r.get("kind") == "obs_epoch"]
    steps = [r for r in records if r.get("kind") == "obs_step"]
    alerts = [r for r in records if r.get("kind") == "obs_alert"]
    # obs_crash records (a restarted run reporting its predecessor's
    # death, tpunet_torch/obs/flightrec/) surface in the alert feed: a crash
    # is the page of pages. They keep their own count in totals.
    crashes = [r for r in records if r.get("kind") == "obs_crash"]
    alerts = alerts + [{**r, "reason": "crash", "severity": "fatal",
                        "step": r.get("step", 0)} for r in crashes]

    totals: Dict = {"epochs": len(epochs), "obs_epochs": len(obs),
                    "obs_steps": len(steps), "alerts": len(alerts)}
    if crashes:
        totals["crashes"] = len(crashes)
    if obs:
        stall = sum(r.get("input_stall_s", 0.0) for r in obs)
        train = sum(r.get("train_seconds", 0.0) for r in obs)
        totals["input_stall_s"] = round(stall, 4)
        totals["train_seconds"] = round(train, 4)
        totals["stall_frac"] = round(stall / train, 4) if train else 0.0
        last = obs[-1]
        totals["last_step"] = last.get("step")
        for k in ("examples_per_sec", "tokens_per_sec", "mfu"):
            if last.get(k) is not None:
                totals[k] = last[k]
        peaks = [m.get("peak_bytes_in_use")
                 for r in obs for m in r.get("device_memory", [])
                 if m.get("peak_bytes_in_use") is not None]
        if peaks:
            totals["peak_bytes_in_use"] = max(peaks)
        beats = [r.get("live_processes") for r in obs
                 if r.get("live_processes") is not None]
        if beats:
            totals["live_processes"] = beats[-1]
    return {
        "epochs": epochs,
        "obs_epochs": obs,
        "step_windows": step_windows(steps, n_windows),
        "alerts": alerts,
        "totals": totals,
    }
