"""Metrics registry: named counters and histograms.

A copy of the part of ``tpunet/obs/registry.py`` (framework-free) that
the classify batcher uses, so that port metrics keep the JAX package's
names and ``snapshot()`` keys. Gauges, record sinks and identity
stamping come with the slices that use them (the trainer, the obs
slice).

The instruments are host-side only (plain Python floats): observing a
value never touches a device or forces a sync.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List


def percentile_of_sorted(xs: List[float], q: float) -> float:
    """Linear-interpolated q-th percentile (q in [0, 100]) of an
    already-sorted non-empty list (the JAX package's definition)."""
    if len(xs) == 1:
        return xs[0]
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class Counter:
    """Monotonically increasing sum. ``inc`` is thread-safe: the serving
    path increments from handler threads concurrently with the worker,
    and an unlocked float read-modify-write can lose updates."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Distribution with bounded memory.

    Up to ``max_samples`` observations are stored exactly (exact
    percentiles); beyond it, reservoir sampling (Vitter's Algorithm R,
    seeded so runs are reproducible) keeps a uniform sample and the
    percentiles become approximate — ``count`` and the mean stay exact
    either way. ``observe`` and ``summary`` hold a lock, as observers
    and readers run on different threads.
    """

    __slots__ = ("values", "max_samples", "_count", "_total", "_rng",
                 "_lock")

    DEFAULT_MAX_SAMPLES = 65536

    def __init__(self, max_samples: int = DEFAULT_MAX_SAMPLES):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.values: List[float] = []
        self.max_samples = max_samples
        self._count = 0
        self._total = 0.0
        self._rng = random.Random(0x0B5)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._total += value
            if len(self.values) < self.max_samples:
                self.values.append(value)
                return
            # Algorithm R: keep each of the n seen so far with
            # probability max_samples/n.
            j = self._rng.randrange(self._count)
            if j < self.max_samples:
                self.values[j] = value

    def summary(self) -> Dict[str, float]:
        """{count, mean, p50, p90, p99} (empty on no observations), plus
        ``approx: 1`` once the reservoir is saturated."""
        with self._lock:
            xs = sorted(self.values)
            count, total = self._count, self._total
        if not xs:
            return {}
        out = {
            "count": count,
            "mean": total / count,
            "p50": percentile_of_sorted(xs, 50),
            "p90": percentile_of_sorted(xs, 90),
            "p99": percentile_of_sorted(xs, 99),
        }
        if count > self.max_samples:
            out["approx"] = 1
        return out


class Registry:
    """Named instruments. ``counter``/``histogram`` are get-or-create, so
    call sites never coordinate registration. Creation and ``snapshot()``
    hold a lock: a reader may snapshot while the worker creates
    instruments."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name in self._histograms:
                raise ValueError(f"instrument name {name!r} already "
                                 "registered as a histogram")
            return self._counters.setdefault(name, Counter())

    def histogram(self, name: str,
                  max_samples: int = Histogram.DEFAULT_MAX_SAMPLES
                  ) -> Histogram:
        with self._lock:
            if name in self._counters:
                raise ValueError(f"instrument name {name!r} already "
                                 "registered as a counter")
            if name not in self._histograms:
                self._histograms[name] = Histogram(max_samples)
            return self._histograms[name]

    def snapshot(self) -> Dict[str, float]:
        """Flat {name: value} view: counters by name, histograms as
        ``name_p50`` etc. A derived histogram key that matches a counter's
        name is suffixed with ``_hist`` instead of overwriting it."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, c in self._counters.items():
                out[name] = c.value
            for name, h in self._histograms.items():
                for k, v in h.summary().items():
                    key = f"{name}_{k}"
                    while key in out:
                        key += "_hist"
                    out[key] = v
        return out
