"""Cross-stream merge math: exact where exactness is possible,
bounded-error where it is not.

Counts and sums merge exactly (they are sums). Quantiles do not:
each stream exports only a bounded sample of its window
(``Histogram.export_sample``), so a merged quantile is an estimate —
but an estimate with a *known* rank-space error bound, which is the
difference between "fleet p99 is 38 ms" and a number nobody can argue
from.

The bound, stream by stream (k = exported sample size, n = window
count):

- unsaturated window (n <= reservoir bound): the reservoir holds the
  window exactly; the only loss is export striding, rank error
  <= 1/(2k) (the export keeps the values at ranks (i + 0.5)/k).
- saturated window: the reservoir is a uniform sample; by the DKW
  inequality its empirical CDF is within
  eps(k) = sqrt(ln(2/alpha) / (2k)) of the window's, with probability
  1 - alpha (we quote alpha = 0.01), plus the same striding term.

For the merged distribution F = sum_i w_i F_i (w_i = n_i / sum n),
|F_hat - F| <= sum_i w_i * eps_i — the weighted average of per-stream
bounds. ``rank_error_bound`` computes exactly that; the acceptance
test checks merged quantiles against ground truth through it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# (sorted sample, exact window count, saturated?) per stream.
Part = Tuple[Sequence[float], int, bool]

DKW_ALPHA = 0.01


def dkw_epsilon(k: int, alpha: float = DKW_ALPHA) -> float:
    """DKW bound on sup|F_k - F| for a k-point uniform sample, at
    confidence 1 - alpha."""
    if k < 1:
        return 1.0
    return math.sqrt(math.log(2.0 / alpha) / (2.0 * k))


def part_rank_error(sample_n: int, saturated: bool) -> float:
    """One stream's rank-space quantile error: export striding always,
    reservoir sampling only once the window saturated."""
    if sample_n < 1:
        return 1.0
    err = 1.0 / (2.0 * sample_n)
    if saturated:
        err += dkw_epsilon(sample_n)
    return err


def rank_error_bound(parts: List[Part]) -> float:
    """Weighted-average rank error of the merged quantile estimate
    (weights = exact window counts)."""
    total = sum(max(0, n) for _, n, _ in parts)
    if total <= 0:
        return 1.0
    return sum((n / total) * part_rank_error(len(s), sat)
               for s, n, sat in parts if n > 0)


def merged_mean(parts: List[Tuple[float, int]]) -> Optional[float]:
    """Exact merged mean from per-stream (mean, count) pairs."""
    total = sum(n for _, n in parts if n > 0)
    if total <= 0:
        return None
    return sum(m * n for m, n in parts if n > 0) / total


def merged_quantiles(parts: List[Part],
                     qs: Sequence[float]) -> Dict[float, float]:
    """Quantiles of the merged distribution, q in [0, 100].

    Each stream's sample points stand for count/len(sample) window
    observations apiece; the merged quantile is the weighted quantile
    over the pooled points (midpoint positions, linear interpolation
    between adjacent points — the same interpolation family as
    ``percentile_of_sorted``, degenerating to it when there is one
    stream whose sample is its whole window)."""
    pts: List[Tuple[float, float]] = []
    for sample, count, _ in parts:
        if not sample or count <= 0:
            continue
        w = count / len(sample)
        pts.extend((float(v), w) for v in sample)
    if not pts:
        return {}
    pts.sort(key=lambda p: p[0])
    total = sum(w for _, w in pts)
    # Midpoint cumulative positions: point i sits at
    # (sum of weights before it + w_i / 2) / total in [0, 1].
    positions: List[float] = []
    cum = 0.0
    for _, w in pts:
        positions.append((cum + w / 2.0) / total)
        cum += w
    out: Dict[float, float] = {}
    for q in qs:
        frac = min(1.0, max(0.0, q / 100.0))
        if frac <= positions[0]:
            out[q] = pts[0][0]
            continue
        if frac >= positions[-1]:
            out[q] = pts[-1][0]
            continue
        # Binary search for the bracketing pair, then interpolate.
        lo, hi = 0, len(positions) - 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if positions[mid] <= frac:
                lo = mid
            else:
                hi = mid
        span = positions[hi] - positions[lo]
        t = (frac - positions[lo]) / span if span > 0 else 0.0
        out[q] = pts[lo][0] * (1.0 - t) + pts[hi][0] * t
    return out


def record_parts(records: List[dict], sample_key: str,
                 count_key: str) -> List[Part]:
    """Extract merge parts from records carrying an exported sample
    (``<name>_sample`` lists; docs/metrics_schema.md). Records without
    the sample are skipped — a mixed-version fleet degrades to fewer
    streams, not to wrong numbers."""
    base = (sample_key[:-len("_sample")]
            if sample_key.endswith("_sample") else sample_key)
    parts: List[Part] = []
    for r in records:
        sample = r.get(sample_key)
        count = r.get(count_key)
        if not sample or not count:
            continue
        # <base>_approx marks a reservoir-saturated source window
        # (step_time_approx, ttft_approx, ...): its DKW term joins
        # the bound.
        saturated = bool(r.get(base + "_approx"))
        parts.append((sample, int(count), saturated))
    return parts
