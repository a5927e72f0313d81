"""Aggregation receiver: N record streams in, one fleet state out.

The ingest side accepts the two transports that already exist — the
ndjson POST bodies ``HttpLineTransport`` sends (the dashboard's
``--listen`` mode hands each parsed record here) and offline replay of
``metrics.jsonl`` files — and routes records into per-stream digests
by the identity stamp (``run_id``/``process_index``) every record now
carries. Records from a pre-identity producer fall back to the
caller's ``source`` tag (one file = one stream), so replaying old
files still works.

``ingest`` is thread-safe (the listen mode's HTTP handler threads call
it concurrently) and O(1) per record; ``rollup()`` is computed on
demand and is a pure function of the ingested records, so concurrent
live ingest and offline replay of the same streams agree exactly.
``emit_rollup()`` additionally publishes the fleet state: flat gauges
into the aggregator's own registry (so ``GaugePredicate`` rules and
exporters compose), one ``obs_fleet`` record to the registry's sinks,
and the alert bridge's ``obs_alert`` records for straggler / stale /
memory-growth / operator-rule conditions.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from tpunet_torch.obs.agg.alerts import AlertBridge
from tpunet_torch.obs.agg.rollup import StreamState, fleet_rollup
from tpunet_torch.obs.registry import Registry


def stream_key(record: dict, source: str = "") -> str:
    """One stream per (run_id, process_index); identity-less records
    group by their source tag (file path / peer address)."""
    rid = record.get("run_id")
    if rid:
        return f"{rid}/{record.get('process_index', 0)}"
    return source or "anon"


class Aggregator:
    def __init__(self, *, registry: Optional[Registry] = None,
                 clock=time.monotonic,
                 straggler_factor: float = 2.0,
                 stream_stale_s: float = 0.0,
                 mem_growth_bytes_per_epoch: float = 0.0,
                 rules=()):
        self.registry = registry if registry is not None else Registry()
        self._clock = clock
        self._streams: Dict[str, StreamState] = {}
        self._lock = threading.Lock()
        self.bridge = AlertBridge(
            self.registry, straggler_factor=straggler_factor,
            stream_stale_s=stream_stale_s,
            mem_growth_bytes_per_epoch=mem_growth_bytes_per_epoch,
            rules=rules)

    # -- ingest ----------------------------------------------------------

    def ingest(self, record: dict, source: str = "",
               stamp_time: bool = True) -> None:
        """Route one record into its stream digest. ``stamp_time=False``
        is the offline-replay mode: no arrival clock is recorded, so
        replayed state is byte-identical to live state for everything
        except the (clock-derived, opt-in) staleness signals."""
        if not isinstance(record, dict):
            return
        key = stream_key(record, source)
        now = self._clock() if stamp_time else None
        with self._lock:
            state = self._streams.get(key)
            if state is None:
                state = self._streams[key] = StreamState(key, source)
            state.ingest(record, now)
        self.registry.counter("agg_records_total").inc()

    def ingest_many(self, records, source: str = "",
                    stamp_time: bool = True) -> None:
        for r in records:
            self.ingest(r, source, stamp_time)

    def replay_file(self, path: str) -> int:
        """Offline ingest of a whole metrics.jsonl (tolerates the torn
        trailing line like every other reader). Returns the record
        count."""
        from tpunet_torch.utils.logging import MetricsLogger
        records = MetricsLogger.read_records(path)
        self.ingest_many(records, source=path, stamp_time=False)
        return len(records)

    def drop_source(self, source: str) -> None:
        """Forget every stream fed from ``source`` — the tailed file
        was truncated by a fresh run; merging two runs' records would
        corrupt every aggregate (same contract as the single-stream
        dashboard's buffer clear)."""
        with self._lock:
            self._streams = {k: s for k, s in self._streams.items()
                             if s.source != source}

    # -- views -----------------------------------------------------------

    def streams(self) -> List[StreamState]:
        with self._lock:
            return sorted(self._streams.values(), key=lambda s: s.key)

    def rollup(self) -> dict:
        # Computed under the ingest lock: handler threads mutate the
        # per-stream deques concurrently in listen mode, and iterating
        # a mutating deque raises. Pure reads — contention is one
        # O(streams) pass.
        with self._lock:
            return fleet_rollup(sorted(self._streams.values(),
                                       key=lambda s: s.key))

    def recent_alerts(self) -> List[dict]:
        """Recently ingested per-run ``obs_alert`` records (bounded
        per stream), each tagged with its stream key — the fleet
        panels surface per-run pages (thread_stalled, step_stall,
        ...) and crash records alongside the bridge's own fleet
        alerts."""
        out: List[dict] = []
        for s in self.streams():
            for a in list(s.recent_alerts):
                row = dict(a)
                row.setdefault("scope", "run")
                row.setdefault("stream", s.key)
                out.append(row)
            if s.last_crash is not None:
                row = {"reason": "crash", "scope": "run",
                       "stream": s.key, "severity": "fatal"}
                for field in ("cause", "signal", "report_path"):
                    if s.last_crash.get(field) is not None:
                        row[field] = s.last_crash[field]
                out.append(row)
        return out

    def heartbeat_ages(self) -> Dict[str, float]:
        """Seconds since each stream's last record arrived (live mode
        only — replayed streams have no arrival clock)."""
        now = self._clock()
        return {s.key: round(now - s.last_seen, 2)
                for s in self.streams() if s.last_seen is not None}

    # -- publication -----------------------------------------------------

    def emit_rollup(self, check_alerts: bool = True) -> dict:
        """Compute the rollup, mirror its flat numeric fields into the
        registry as fleet gauges, run the alert bridge, and emit one
        ``obs_fleet`` record to the registry's sinks. Returns the
        rollup (with ``fleet_alerts`` appended when any fired)."""
        streams = self.streams()
        rollup = self.rollup()
        for key, val in rollup.items():
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            self.registry.gauge(f"fleet_{key}").set(val)
        if check_alerts:
            fired = self.bridge.check(rollup, streams,
                                      now=self._clock())
            if fired:
                rollup = dict(rollup)
                rollup["fleet_alerts"] = fired
        self.registry.emit("obs_fleet", rollup)
        return rollup
