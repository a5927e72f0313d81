"""Cross-run regression compare with honest error bars.

Comparing two runs' step-time percentiles naively calls every wobble a
regression: each run's quantiles are estimates from bounded exported
samples (``Histogram.export_sample``), so the comparison must carry
the same DKW + striding rank-error bound the fleet merge math already
quantifies (``tpunet_torch/obs/agg/merge.py``). The rule here: a
"regression" verdict is only emitted when the two runs' quantile
*confidence intervals* — each quantile widened by its own rank-error
bound, translated to value space through the run's own sample — do
not overlap. Everything inside the bars is ``within_error``, which is
the honest answer, not a hedge.

Alignment: two runs of the same config fingerprint are compared over
their overlapping global-step range (epoch windows fully inside the
overlap), so a short run's warmup is never judged against a long
run's steady state. Exact scalars (throughput, MFU) have no sampling
error bar; they get a relative ``tolerance`` instead, mirroring the
byte/serve budget gates.

The result dict is the ``obs_regression`` record body
(docs/metrics_schema.md) — ``scripts/obs_compare.py`` exit-codes on
its ``verdict``, the fleet dashboard renders it, and the alert
webhook pages on it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from tpunet_torch.obs.agg import merge

QUANTILES = (50, 90, 99)

#: Relative tolerance for exact scalars (throughput, MFU) — same
#: spirit as docs/bytes_budget.json's tolerance_frac.
DEFAULT_TOLERANCE = 0.05

VERDICT_REGRESSION = "regression"
VERDICT_IMPROVEMENT = "improvement"
VERDICT_WITHIN_ERROR = "within_error"
VERDICT_OK = "ok"
VERDICT_INCOMPARABLE = "incomparable"


def _window_span(w: dict) -> Optional[Tuple[int, int]]:
    step, steps = w.get("step"), int(w.get("steps") or 0)
    if step is None or steps <= 0:
        return None
    return (step - steps + 1, step)


def overlap_range(a: dict, b: dict) -> Optional[Tuple[int, int]]:
    """Overlapping global-step range of two run summaries; None when
    either run carries no step extent or they never overlap."""
    if None in (a.get("step_lo"), a.get("step_hi"),
                b.get("step_lo"), b.get("step_hi")):
        return None
    lo = max(a["step_lo"], b["step_lo"])
    hi = min(a["step_hi"], b["step_hi"])
    return (lo, hi) if lo <= hi else None


def aligned_windows(summary: dict,
                    step_range: Optional[Tuple[int, int]] = None
                    ) -> List[dict]:
    """A summary's epoch windows restricted to those fully inside
    ``step_range`` (falling back to windows that merely intersect it
    when none fit — two runs whose epoch grids disagree still
    compare, on the closest-aligned data available)."""
    windows = summary.get("epoch_windows") or []
    if step_range is None:
        return list(windows)
    lo, hi = step_range
    inside, touching = [], []
    for w in windows:
        span = _window_span(w)
        if span is None:
            continue
        if span[0] >= lo and span[1] <= hi:
            inside.append(w)
        elif span[1] >= lo and span[0] <= hi:
            touching.append(w)
    return inside if inside else touching


def window_parts(summary: dict,
                 step_range: Optional[Tuple[int, int]] = None
                 ) -> List[merge.Part]:
    """Merge parts from a summary's (aligned) epoch windows."""
    out: List[merge.Part] = []
    for w in aligned_windows(summary, step_range):
        sample = w.get("sample")
        steps = int(w.get("steps") or 0)
        if sample and steps > 0:
            out.append((sample, steps, bool(w.get("approx"))))
    return out


def _aligned_scalar(summary: dict, key: str,
                    step_range: Optional[Tuple[int, int]]
                    ) -> Optional[float]:
    """Steps-weighted mean of a per-window scalar over the SAME
    aligned window set the quantiles use — a short run's compile/
    warmup epochs must not weigh into its mean any more than they
    weigh into its percentiles (they fall outside the overlap, or
    carry their own small step weight inside it)."""
    num = den = 0.0
    for w in aligned_windows(summary, step_range):
        v = w.get(key)
        steps = int(w.get("steps") or 0)
        if v is not None and steps > 0:
            num += v * steps
            den += steps
    return num / den if den > 0 else None


def quantile_verdict(parts_a: List[merge.Part],
                     parts_b: List[merge.Part], q: float,
                     *, larger_is_worse: bool = True) -> Optional[dict]:
    """One quantile's comparison row, or None when either side has no
    sample data.

    The interval for run X at quantile q is
    ``[Q_X(q - err_X), Q_X(q + err_X)]`` where ``err_X`` is the run's
    rank-error bound (striding + DKW, ``merge.rank_error_bound``): the
    true quantile's rank is within ``err_X`` of q, so its value lies
    between the estimated quantiles at the shifted ranks. Disjoint
    intervals are a verdict; overlapping ones are ``within_error``.
    """
    if not parts_a or not parts_b:
        return None
    err_a = merge.rank_error_bound(parts_a)
    err_b = merge.rank_error_bound(parts_b)

    def interval(parts, err):
        qs = (max(0.0, q - 100.0 * err), q, min(100.0, q + 100.0 * err))
        m = merge.merged_quantiles(parts, qs)
        return m[qs[0]], m[q], m[qs[2]]

    a_lo, a, a_hi = interval(parts_a, err_a)
    b_lo, b, b_hi = interval(parts_b, err_b)
    if b_lo > a_hi:
        verdict = (VERDICT_REGRESSION if larger_is_worse
                   else VERDICT_IMPROVEMENT)
    elif b_hi < a_lo:
        verdict = (VERDICT_IMPROVEMENT if larger_is_worse
                   else VERDICT_REGRESSION)
    else:
        verdict = VERDICT_WITHIN_ERROR
    return {
        "a": round(a, 6), "b": round(b, 6),
        "delta": round(b - a, 6),
        "delta_frac": round((b - a) / a, 4) if a else None,
        "a_lo": round(a_lo, 6), "a_hi": round(a_hi, 6),
        "b_lo": round(b_lo, 6), "b_hi": round(b_hi, 6),
        "rank_err_a": round(err_a, 4), "rank_err_b": round(err_b, 4),
        "verdict": verdict,
    }


def _scalar_row(metric: str, a, b, tolerance: float,
                larger_is_worse: bool) -> Optional[dict]:
    """Exact-scalar comparison (throughput, MFU): no sampling error,
    so the bar is a relative tolerance."""
    if a is None or b is None or a == 0:
        return None
    delta_frac = (b - a) / abs(a)
    worse = delta_frac > tolerance if larger_is_worse \
        else delta_frac < -tolerance
    better = delta_frac < -tolerance if larger_is_worse \
        else delta_frac > tolerance
    return {
        "metric": metric, "a": round(a, 6), "b": round(b, 6),
        "delta": round(b - a, 6), "delta_frac": round(delta_frac, 4),
        "tolerance": tolerance,
        "verdict": (VERDICT_REGRESSION if worse
                    else VERDICT_IMPROVEMENT if better
                    else VERDICT_WITHIN_ERROR),
    }


def _serve_parts(summary: dict, key: str) -> List[merge.Part]:
    raw = (summary.get("serve") or {}).get(f"{key}_parts") or []
    return [(s, int(n), bool(sat)) for s, n, sat in raw]


def _trace_parts(summary: dict, key: str) -> List[merge.Part]:
    raw = (summary.get("trace") or {}).get(f"{key}_parts") or []
    return [(s, int(n), bool(sat)) for s, n, sat in raw]


def compare_summaries(a: dict, b: dict, *,
                      quantiles: Sequence[float] = QUANTILES,
                      tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Two run summaries (``store.summarize_run``) -> one
    ``obs_regression`` record body. ``a`` is the baseline; verdicts
    describe ``b`` relative to it."""
    fp_a = a.get("config_fingerprint")
    fp_b = b.get("config_fingerprint")
    out: dict = {
        "run_a": a.get("run_id") or a.get("source", ""),
        "run_b": b.get("run_id") or b.get("source", ""),
        "fingerprint_match": (fp_a == fp_b
                              if fp_a and fp_b else None),
    }
    if fp_a:
        out["config_fingerprint"] = fp_a
    rng = overlap_range(a, b)
    if rng is not None:
        out["step_lo"], out["step_hi"] = rng

    metrics: List[dict] = []
    parts_a = window_parts(a, rng)
    parts_b = window_parts(b, rng)
    out["windows_a"] = len(parts_a)
    out["windows_b"] = len(parts_b)
    for q in quantiles:
        row = quantile_verdict(parts_a, parts_b, q)
        if row is not None:
            metrics.append({"metric": f"step_time_p{q:g}_s", **row})
    # Scalars are aligned to the SAME overlap windows as the
    # quantiles (a 3-epoch candidate's compile epoch must not carry
    # 1/3 weight against a 30-epoch baseline's 1/30); the whole-run
    # summary means are only a fallback for fingerprint-stamped but
    # window-less streams.
    thr_key = {"tokens": "tokens_per_sec",
               "examples": "examples_per_sec"}.get(
                   a.get("throughput_unit") or b.get("throughput_unit"))
    scalars = []
    if thr_key:
        scalars.append(("throughput_mean", thr_key))
    scalars.append(("mfu", "mfu"))
    for metric, key in scalars:
        va = _aligned_scalar(a, key, rng)
        vb = _aligned_scalar(b, key, rng)
        if va is None or vb is None:
            va, vb = a.get(metric), b.get(metric)
        row = _scalar_row(metric, va, vb, tolerance,
                          larger_is_worse=False)
        if row is not None:
            metrics.append(row)
    for key in ("ttft", "e2e"):
        sp_a, sp_b = _serve_parts(a, key), _serve_parts(b, key)
        for q in quantiles:
            row = quantile_verdict(sp_a, sp_b, q)
            if row is not None:
                metrics.append({"metric": f"serve_{key}_p{q:g}_s",
                                **row})
    # Trace-phase quantiles (store.TRACE_PHASES): the TTFT
    # decomposition, so a serve regression names the phase it lives
    # in (queue grew vs prefill grew) instead of just the symptom.
    for key in ("queue", "prefill", "first_decode"):
        tp_a, tp_b = _trace_parts(a, key), _trace_parts(b, key)
        for q in quantiles:
            row = quantile_verdict(tp_a, tp_b, q)
            if row is not None:
                metrics.append({"metric": f"trace_{key}_p{q:g}_s",
                                **row})
    out["metrics"] = metrics
    out["regressions"] = sum(
        1 for m in metrics if m["verdict"] == VERDICT_REGRESSION)
    out["improvements"] = sum(
        1 for m in metrics if m["verdict"] == VERDICT_IMPROVEMENT)
    for side, run in (("a", a), ("b", b)):
        for key in ("alerts", "crashes"):
            if run.get(key):
                out[f"{key}_{side}"] = run[key]
    if not metrics:
        out["verdict"] = VERDICT_INCOMPARABLE
    elif out["regressions"]:
        out["verdict"] = VERDICT_REGRESSION
    else:
        out["verdict"] = VERDICT_OK
    return out


def emit_regression(registry, comparison: dict) -> None:
    """One ``obs_regression`` record through a Registry, so it reaches
    metrics sinks, live exporters, and the alert webhook (which pages
    on the kind when the verdict says regression)."""
    registry.emit("obs_regression", comparison)


def stream_regressions(streams) -> List[dict]:
    """Fleet-dashboard panel rows: pairwise last-window compare of
    trainer streams sharing a config fingerprint (identity-stamped
    since this PR). Baseline = lexicographically-first stream key per
    fingerprint group, so the pairing is deterministic under replay."""
    by_fp: dict = {}
    for s in streams:
        fp = (s.identity or {}).get("config_fingerprint")
        if fp and s.last_epoch is not None:
            by_fp.setdefault(fp, []).append(s)
    rows: List[dict] = []
    for fp in sorted(by_fp):
        group = sorted(by_fp[fp], key=lambda s: s.key)
        if len(group) < 2:
            continue
        base = group[0]
        parts_a = merge.record_parts([base.last_epoch],
                                     "step_time_sample", "steps")
        for other in group[1:]:
            parts_b = merge.record_parts([other.last_epoch],
                                         "step_time_sample", "steps")
            row = quantile_verdict(parts_a, parts_b, 50)
            if row is None:
                continue
            rows.append({"fingerprint": fp, "base": base.key,
                         "stream": other.key,
                         "metric": "step_time_p50_s", **row})
    return rows
