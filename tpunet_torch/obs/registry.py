"""Metrics registry: counters, gauges, histograms with pluggable sinks.

A copy of ``tpunet/obs/registry.py`` (framework-free), so that port
metrics and records keep the JAX package's names, ``snapshot()`` keys
and record shapes.

The instruments are deliberately host-side-only (plain Python floats):
observing a value never touches a device or forces a sync — the caller
decides when device values become host floats. Sinks receive finished
*records* (flat JSON-able dicts tagged with a ``kind``), not raw
observations, so the per-step hot path never formats or writes
anything; records are built at window edges (epoch boundaries, opt-in
per-step sampling).
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional


def percentile_of_sorted(xs: List[float], q: float) -> float:
    """Linear-interpolated q-th percentile (q in [0, 100]) of an
    already-sorted non-empty list. THE percentile definition for the
    whole obs subsystem — Histogram summaries and the
    summary/dashboard/report pipeline all call this one function, so
    live views can never drift from the trainer's emitted records."""
    if len(xs) == 1:
        return xs[0]
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class Counter:
    """Monotonically increasing sum (e.g. checkpoint saves, stall
    seconds). ``inc`` is thread-safe: the serving path increments from
    HTTP handler threads concurrently with the engine thread, and an
    unlocked float read-modify-write can lose updates."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    """Last-write-wins sample (e.g. device bytes in use). The single
    float store in ``set`` is atomic under the GIL today; the lock
    exists to pin the instrument-mutation discipline (Counter and
    Histogram hold one) so a future compound setter — min/max
    tracking, delta-from-previous — cannot silently reintroduce the
    serve-path race between HTTP handler threads and the engine."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Histogram:
    """Windowed distribution with bounded memory.

    Observations accumulate in a list until ``reset()`` (one window ==
    one epoch in the trainer); percentiles sort a copy on demand, so
    ``observe`` is a single append — cheap enough for the per-step
    path. Up to ``max_samples`` observations the window is stored
    exactly (exact percentiles); beyond it, reservoir sampling
    (Vitter's Algorithm R, seeded so runs are reproducible) keeps a
    uniform sample of the window and percentiles become approximate —
    ``count`` and ``total`` stay exact either way. The default bound
    holds a long epoch of float laps in ~0.5 MB.

    ``observe`` (and every reader) holds a lock: the serving path
    observes ``serve_*`` latency histograms from HTTP handler threads
    concurrently with the engine thread, and the unlocked
    count/total/reservoir updates lose observations under that race —
    same discipline as ``Counter.inc``, one uncontended acquire on the
    trainer's single-threaded hot path.
    """

    __slots__ = ("values", "max_samples", "_count", "_total", "_rng",
                 "_lock")

    DEFAULT_MAX_SAMPLES = 65536
    # Bound on the per-record exported sample (``export_sample``):
    # large enough that rank-space quantile error stays small (see
    # docs/metrics_schema.md), small enough that an obs_epoch record
    # stays a few KB.
    EXPORT_SAMPLE_MAX = 256

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
            # Reservoir (Algorithm R): keep each of the n seen so far
            # with probability max_samples/n — percentiles degrade to a
            # uniform sample of the window instead of the list growing
            # unboundedly.
            j = self._rng.randrange(self._count)
            if j < self.max_samples:
                self.values[j] = value

    def __len__(self) -> int:
        return self._count

    @property
    def saturated(self) -> bool:
        """True once the window overflowed the exact bound (percentiles
        are reservoir approximations from here on)."""
        return self._count > self.max_samples

    @property
    def total(self) -> float:
        return self._total

    _interp = staticmethod(percentile_of_sorted)

    def percentile(self, q: float) -> Optional[float]:
        """Linear-interpolated q-th percentile (q in [0, 100]); None on
        an empty window."""
        with self._lock:
            xs = sorted(self.values)
        if not xs:
            return None
        return self._interp(xs, q)

    def summary(self) -> Dict[str, float]:
        """{count, mean, p50, p90, p99} of the current window (empty
        dict on an empty window); one sort serves all three
        percentiles. ``count``/``mean`` are exact even when the window
        saturated the reservoir (percentiles are then approximate, and
        the summary says so with ``approx: 1``)."""
        with self._lock:
            xs = sorted(self.values)
            count, total = self._count, self._total
        if not xs:
            return {}
        out = {
            "count": count,
            "mean": total / count,
            "p50": self._interp(xs, 50),
            "p90": self._interp(xs, 90),
            "p99": self._interp(xs, 99),
        }
        if count > self.max_samples:
            out["approx"] = 1
        return out

    def export_sample(self, max_n: int = EXPORT_SAMPLE_MAX) -> List[float]:
        """The window's bounded sample, sorted, for cross-stream
        percentile merging (the JAX package's fleet aggregator). Up to ``max_n``
        points the stored sample is returned whole; beyond that it is
        compressed to ``max_n`` rank-strided points — the values at
        ranks (i + 0.5)/max_n — which preserves any quantile of the
        stored sample to within 1/(2*max_n) in rank. Combined with the
        reservoir's own DKW bound once saturated, a merged quantile's
        total rank error is documented in docs/metrics_schema.md."""
        with self._lock:
            xs = sorted(self.values)
        if len(xs) <= max_n:
            return xs
        return [xs[int((i + 0.5) * len(xs) / max_n)] for i in range(max_n)]

    def reset(self) -> None:
        with self._lock:
            self.values = []
            self._count = 0
            self._total = 0.0


class MemorySink:
    """In-memory sink for tests: records land in ``self.records``."""

    def __init__(self):
        self.records: List[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def by_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r.get("kind") == kind]


class JsonlSink:
    """Sink adapter over ``MetricsLogger`` — obs records share the
    run's ``metrics.jsonl`` (one append-mode file, coordinator-only
    writes; MetricsLogger already enforces both)."""

    def __init__(self, logger):
        self._logger = logger

    def write(self, record: dict) -> None:
        self._logger.log(record)


class Registry:
    """Named instruments + sinks. ``counter``/``gauge``/``histogram``
    are get-or-create, so call sites never coordinate registration.

    Creation and ``snapshot()`` hold a lock: the serving frontend
    snapshots from HTTP handler threads while the engine thread
    lazily creates instruments, and an unguarded dict iteration over
    a mutating family raises RuntimeError. The trainer's
    single-threaded hot path pays one uncontended acquire per
    get-or-create call (instrument methods themselves stay lock-free
    except Counter.inc)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sinks: list = []
        self._lock = threading.Lock()
        self._identity: Dict[str, object] = {}

    def set_identity(self, **fields) -> None:
        """Stamp every subsequently emitted record with these fields
        (``run_id`` / ``process_index`` / ``host`` — the join keys the
        fleet aggregator routes streams by; docs/metrics_schema.md
        "Run identity"). None values are dropped; an explicit record
        field of the same name wins over the stamp."""
        self._identity = {k: v for k, v in fields.items()
                          if v is not None}

    def identity(self) -> Dict[str, object]:
        return dict(self._identity)

    def _claim(self, name: str, family: Dict) -> None:
        """One name, one instrument family: a counter and a gauge
        sharing a name used to collide silently in ``snapshot()``
        (last writer won); refuse at creation instead."""
        for other in (self._counters, self._gauges, self._histograms):
            if other is not family and name in other:
                kind = {id(self._counters): "counter",
                        id(self._gauges): "gauge",
                        id(self._histograms): "histogram"}[id(other)]
                raise ValueError(
                    f"instrument name {name!r} already registered as a "
                    f"{kind}; one name maps to one snapshot() key")

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._claim(name, self._counters)
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._claim(name, self._gauges)
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  max_samples: int = Histogram.DEFAULT_MAX_SAMPLES
                  ) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._claim(name, self._histograms)
                self._histograms[name] = Histogram(max_samples)
            return self._histograms[name]

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def emit(self, kind: str, record: dict) -> None:
        """Tag, identity-stamp, and fan a finished record out to every
        sink."""
        rec = {"kind": kind}
        rec.update(self._identity)
        rec.update(record)
        for sink in self._sinks:
            sink.write(rec)

    def snapshot(self) -> Dict[str, float]:
        """Flat {name: value} view of every instrument: counters and
        gauges by name, histograms as ``name_p50`` etc. Cross-family
        duplicates are refused at creation; the one collision class
        left — a derived histogram key (``lap_p50``) matching a literal
        counter/gauge name — is disambiguated by suffixing the derived
        key with ``_hist`` instead of silently overwriting."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, c in self._counters.items():
                out[name] = c.value
            for name, g in self._gauges.items():
                if g.value is not None:
                    out[name] = g.value
            for name, h in self._histograms.items():
                for k, v in h.summary().items():
                    key = f"{name}_{k}"
                    while key in out:
                        key += "_hist"
                    out[key] = v
        return out

    def reset_window(self) -> None:
        """Start a new observation window: histograms clear; counters
        and gauges persist (they are run-cumulative)."""
        with self._lock:
            hists = list(self._histograms.values())
        for h in hists:
            h.reset()
