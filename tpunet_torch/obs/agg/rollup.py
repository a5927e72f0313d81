"""Per-stream state and the fleet rollup.

``StreamState`` is the bounded digest of one record stream the
receiver maintains incrementally (ingest is O(1) per record); the
rollup is computed on demand from the digests. Everything in the
rollup is a pure function of the ingested records — never of arrival
order or wall clock — so a live multi-stream ingest and an offline
replay of the same files produce the *identical* rollup (the
acceptance property the tests pin). The only clock-derived signals,
per-stream staleness ages, live in separate fields the caller opts
into (``heartbeat_ages``).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from tpunet_torch.obs.agg import merge

# Bounded per-stream history: enough epochs for a memory-growth trend,
# enough step records for step-aligned skew, small enough that a
# thousand-stream fleet stays in tens of MB.
EPOCH_KEEP = 64
STEP_KEEP = 512
# Per-stream trace digest bounds (obs_trace, tpunet_torch/obs/tracing.py):
# enough phase samples for stable p99s at default 1% head sampling,
# a handful of slow-request exemplars for the dashboard panel.
TRACE_KEEP = 256
TRACE_SLOW_KEEP = 8
# Per-stream burn-rate history (obs_slo, tpunet_torch/obs/slo.py): enough
# points for the dashboard's burn sparkline over recent emit windows.
SLO_BURN_KEEP = 64


class StreamState:
    """Rolling digest of one record stream (one (run_id,
    process_index) pair — or one replayed file)."""

    def __init__(self, key: str, source: str = ""):
        self.key = key
        self.source = source
        self.identity: Dict[str, object] = {}
        self.records = 0
        self.alerts = 0
        # Recent per-run alert/crash records (dashboard fleet panels
        # show WHAT paged, not just a count); bounded like everything
        # else here.
        self.recent_alerts: deque = deque(maxlen=8)
        self.crashes = 0
        self.last_crash: Optional[dict] = None
        self.last_seen: Optional[float] = None  # receiver clock; live only
        # Training-side digest.
        self.last_epoch: Optional[dict] = None
        self.steps_total = 0            # exact: sum of obs_epoch "steps"
        self.step_time_sum = 0.0        # exact: sum of mean * steps
        self.epoch_p50s: deque = deque(maxlen=EPOCH_KEEP)  # (epoch, p50)
        self.mem_peaks: deque = deque(maxlen=EPOCH_KEEP)   # (epoch, peak)
        self.step_laps: deque = deque(maxlen=STEP_KEEP)    # (step, lap_s)
        # Serving-side digest.
        self.last_serve: Optional[dict] = None
        self.serve_records = 0
        # Router-tier digest (tpunet_torch/router/): the front tier's
        # window records and the evict/respawn/scale events it acted
        # on — the fleet view should say who is steering, not just
        # who is serving.
        self.last_router: Optional[dict] = None
        self.router_records = 0
        self.router_events = 0
        self.last_router_event: Optional[dict] = None
        # Trace digest (``obs_trace``): replica-hop phase samples for
        # the fleet TTFT decomposition (queue vs prefill vs
        # first-decode) and a bounded slowest-trace exemplar pool
        # (top-K by e2e — the dashboard's slow-request panel and the
        # obs_timeline lookup key).
        self.trace_records = 0
        self.trace_phases: deque = deque(maxlen=TRACE_KEEP)
        self.trace_slow: List[dict] = []
        # SLO digest (``obs_slo``, tpunet_torch/obs/slo.py): the last record
        # per SLO name (budget remaining, burn rates, firing state,
        # probe tallies) plus a bounded burn-rate history for the
        # dashboard sparkline.
        self.slo_records = 0
        self.slo_last: Dict[str, dict] = {}
        self.slo_burn: deque = deque(maxlen=SLO_BURN_KEEP)
        # Elasticity digest (tpunet's elastic agent, tpunet/elastic/): membership changes are
        # part of the stream's judgeable history — a shrink explains a
        # throughput step-change the regression panel would otherwise
        # flag blind.
        self.elastic_events = 0
        self.last_elastic: Optional[dict] = None

    # -- ingest ----------------------------------------------------------

    def ingest(self, record: dict, now: Optional[float] = None) -> None:
        self.records += 1
        if now is not None:
            self.last_seen = now
        for k in ("run_id", "process_index", "host",
                  "config_fingerprint"):
            if k in record:
                self.identity[k] = record[k]
        kind = record.get("kind")
        if kind == "obs_epoch":
            self.last_epoch = record
            steps = int(record.get("steps") or 0)
            mean = record.get("step_time_mean_s")
            if steps > 0 and mean is not None:
                self.steps_total += steps
                self.step_time_sum += mean * steps
            p50 = record.get("step_time_p50_s")
            if p50 is not None:
                self.epoch_p50s.append((record.get("epoch", 0), p50))
            peaks = [m.get("peak_bytes_in_use")
                     for m in record.get("device_memory", []) or []
                     if isinstance(m, dict)
                     and m.get("peak_bytes_in_use") is not None]
            if peaks:
                self.mem_peaks.append((record.get("epoch", 0),
                                       max(peaks)))
        elif kind == "obs_step":
            lap = record.get("step_time_s")
            if lap is not None:
                self.step_laps.append((int(record.get("step", 0)), lap))
        elif kind == "obs_serve":
            self.last_serve = record
            self.serve_records += 1
        elif kind == "obs_router":
            self.router_records += 1
            if record.get("event"):
                self.router_events += 1
                self.last_router_event = record
            else:
                self.last_router = record
        elif kind == "obs_alert":
            self.alerts += 1
            self.recent_alerts.append(record)
        elif kind == "obs_crash":
            # A restarted run reporting its previous incarnation's
            # death (tpunet_torch/obs/flightrec/): tracked per stream so the
            # fleet view can say which replica is crash-looping.
            self.crashes += 1
            self.last_crash = record
        elif kind == "obs_slo":
            self.slo_records += 1
            name = str(record.get("name") or "")
            if name:
                self.slo_last[name] = record
            burn = record.get("page_burn_long")
            if burn is not None:
                self.slo_burn.append((name, burn))
        elif kind == "obs_elastic":
            self.elastic_events += 1
            self.last_elastic = record
        elif kind == "obs_trace":
            self.trace_records += 1
            if record.get("role") == "replica":
                self.trace_phases.append(
                    (record.get("queue_s"), record.get("prefill_s"),
                     record.get("first_decode_s")))
            if record.get("e2e_s") is not None:
                # Order-independent top-K (trace_id tie-break): the
                # same files replayed in any order keep the identical
                # exemplar set — the rollup purity property.
                self.trace_slow.append(record)
                self.trace_slow.sort(
                    key=lambda r: (-(r.get("e2e_s") or 0.0),
                                   str(r.get("trace_id", ""))))
                del self.trace_slow[TRACE_SLOW_KEEP:]

    # -- derived ---------------------------------------------------------

    def step_time_p50(self, step_range=None) -> Optional[float]:
        """The stream's representative step time: the median of its
        recent ``obs_step`` laps (restricted to ``step_range`` when
        given — the step-aligned comparison), falling back to the last
        epoch's p50 when no per-step records flow."""
        # list() is one C-level copy — safe against a concurrent
        # append when called outside the aggregator's ingest lock
        # (the dashboard's render path).
        laps = [t for s, t in list(self.step_laps)
                if step_range is None
                or step_range[0] <= s <= step_range[1]]
        if laps:
            laps.sort()
            return laps[len(laps) // 2]
        if self.last_epoch is not None:
            return self.last_epoch.get("step_time_p50_s")
        return None

    def step_span(self):
        if self.step_laps:
            return (self.step_laps[0][0], self.step_laps[-1][0])
        return None

    def last_step(self) -> Optional[int]:
        if self.step_laps:
            return self.step_laps[-1][0]
        if self.last_epoch is not None:
            return self.last_epoch.get("step")
        return None

    def mem_growth_per_epoch(self) -> Optional[float]:
        """Least-squares slope of peak device bytes over epochs — the
        leak shape (bytes/epoch) the fleet watchdog alerts on."""
        if len(self.mem_peaks) < 3:
            return None
        from tpunet_torch.obs.health import _slope
        return _slope(list(self.mem_peaks))

    def throughput(self):
        """(value, unit) from the last epoch record, or None."""
        r = self.last_epoch
        if r is None:
            return None
        for key, unit in (("tokens_per_sec", "tokens"),
                          ("examples_per_sec", "examples")):
            if r.get(key) is not None:
                return r[key], unit
        return None


def _common_step_range(streams: List[StreamState]):
    """Overlapping step range across every stream that emits obs_step
    records — skew compared inside it is step-aligned (same work),
    not warmup-vs-steady-state."""
    spans = [s.step_span() for s in streams]
    spans = [sp for sp in spans if sp is not None]
    if len(spans) < 2:
        return None
    lo = max(sp[0] for sp in spans)
    hi = min(sp[1] for sp in spans)
    return (lo, hi) if lo <= hi else None


def fleet_rollup(streams: List[StreamState]) -> dict:
    """The fleet-level view over every stream digest: exact merged
    counts/means, bounded-error merged percentiles, straggler/skew,
    memory-growth trend, and the serve SLO rollup. Flat numeric fields
    plus one nested ``per_stream`` list (jsonl/HTTP carry it; statsd
    drops non-scalars by design)."""
    streams = sorted(streams, key=lambda s: s.key)
    out: dict = {
        "streams": len(streams),
        "records_total": sum(s.records for s in streams),
        "alerts_total": sum(s.alerts for s in streams),
    }
    crashes = sum(s.crashes for s in streams)
    if crashes:
        out["crashes_total"] = crashes
    elastic = sum(s.elastic_events for s in streams)
    if elastic:
        out["elastic_events_total"] = elastic
        # The most recent membership change across streams: the
        # dashboard head-line ("shrink 2->1, gen 3") without digging
        # per stream.
        last = max((s.last_elastic for s in streams
                    if s.last_elastic is not None),
                   key=lambda r: r.get("time", 0) or 0, default=None)
        if last is not None:
            out["elastic_last_event"] = str(last.get("event", ""))
            if last.get("generation") is not None:
                out["elastic_generation"] = last["generation"]
    per_stream: List[dict] = []

    # -- training rollup -------------------------------------------------
    trainers = [s for s in streams if s.last_epoch is not None]
    if trainers:
        out["steps_total"] = sum(s.steps_total for s in trainers)
        mean = merge.merged_mean([
            (s.step_time_sum / s.steps_total, s.steps_total)
            for s in trainers if s.steps_total > 0])
        if mean is not None:
            out["step_time_mean_s"] = round(mean, 6)
        parts = merge.record_parts(
            [s.last_epoch for s in trainers],
            "step_time_sample", "steps")
        if parts:
            merged = merge.merged_quantiles(parts, (50, 90, 99))
            out["step_time_p50_s"] = round(merged[50], 6)
            out["step_time_p90_s"] = round(merged[90], 6)
            out["step_time_p99_s"] = round(merged[99], 6)
            out["step_time_rank_err"] = round(
                merge.rank_error_bound(parts), 4)
            out["step_time_sample_n"] = sum(len(p[0]) for p in parts)
        thr = [s.throughput() for s in trainers]
        thr = [t for t in thr if t is not None]
        if thr:
            # One summed total PER unit — a mixed fleet (an LM and a
            # classifier run tailed together) must not silently drop
            # the minority unit's streams from "total" throughput.
            sums: Dict[str, float] = {}
            for v, u in thr:
                sums[u] = sums.get(u, 0.0) + v
            for u, v in sums.items():
                out[f"{u}_per_sec"] = round(v, 2)
            if len(sums) == 1:
                out["throughput_unit"] = next(iter(sums))
            else:
                out["throughput_units"] = sorted(sums)
        # Step-aligned straggler/skew: slowest stream vs the median of
        # the REMAINING replicas — with the slowest included, a
        # two-replica fleet's upper median IS the slowest and the
        # factor pins at 1.0 (for two streams this degenerates to
        # slowest/fastest, which is the right two-replica question).
        rng = _common_step_range(trainers)
        p50s = [(s, s.step_time_p50(rng)) for s in trainers]
        p50s = [(s, p) for s, p in p50s if p is not None]
        if len(p50s) >= 2:
            from tpunet_torch.obs.registry import percentile_of_sorted
            slowest, slow_p50 = max(p50s, key=lambda t: t[1])
            others = sorted(p for s, p in p50s if s is not slowest)
            median = percentile_of_sorted(others, 50)
            out["median_step_time_p50_s"] = round(median, 6)
            out["slowest_step_time_p50_s"] = round(slow_p50, 6)
            out["slowest_stream"] = slowest.key
            if median > 0:
                out["straggler_factor"] = round(slow_p50 / median, 4)
        steps = [s.last_step() for s in trainers]
        steps = [s for s in steps if s is not None]
        if steps:
            out["step_min"] = min(steps)
            out["step_max"] = max(steps)
            out["step_lag"] = out["step_max"] - out["step_min"]
        growth = [(s, s.mem_growth_per_epoch()) for s in trainers]
        growth = [(s, g) for s, g in growth if g is not None]
        if growth:
            worst, slope = max(growth, key=lambda t: t[1])
            out["mem_growth_bytes_per_epoch"] = round(slope, 1)
            out["mem_growth_stream"] = worst.key

    # -- serve SLO rollup ------------------------------------------------
    servers = [s for s in streams if s.last_serve is not None]
    if servers:
        out["serve_replicas"] = len(servers)
        for field in ("queue_depth", "active_slots", "slots",
                      "requests_total", "requests_completed",
                      "requests_rejected", "tokens_total"):
            vals = [s.last_serve.get(field) for s in servers]
            vals = [v for v in vals if v is not None]
            if vals:
                out[f"serve_{field}"] = sum(vals)
        req = out.get("serve_requests_total", 0)
        rej = out.get("serve_requests_rejected", 0)
        if req:
            out["serve_reject_rate"] = round(rej / req, 4)
        for key in ("ttft", "e2e"):
            parts = merge.record_parts(
                [s.last_serve for s in servers],
                f"{key}_sample", f"{key}_count")
            if parts:
                merged = merge.merged_quantiles(parts, (50, 90, 99))
                out[f"serve_{key}_p50_s"] = round(merged[50], 6)
                out[f"serve_{key}_p90_s"] = round(merged[90], 6)
                out[f"serve_{key}_p99_s"] = round(merged[99], 6)
                out[f"serve_{key}_rank_err"] = round(
                    merge.rank_error_bound(parts), 4)

    # -- trace SLO decomposition -----------------------------------------
    # Per-phase quantiles over every stream's sampled obs_trace
    # records: the fleet TTFT p99 split into where the time went
    # (admission queue vs prefill compute vs first-decode), plus the
    # fleet-wide slowest-trace exemplars.
    tracers = [s for s in streams if s.trace_records]
    if tracers:
        from tpunet_torch.obs.registry import percentile_of_sorted
        out["trace_records_total"] = sum(s.trace_records
                                         for s in tracers)
        phases = [p for s in tracers for p in list(s.trace_phases)]
        for i, name in enumerate(("queue", "prefill",
                                  "first_decode")):
            vals = sorted(p[i] for p in phases if p[i] is not None)
            if vals:
                out[f"trace_{name}_p50_s"] = round(
                    percentile_of_sorted(vals, 50), 6)
                out[f"trace_{name}_p99_s"] = round(
                    percentile_of_sorted(vals, 99), 6)
        slow = sorted((r for s in tracers for r in s.trace_slow),
                      key=lambda r: (-(r.get("e2e_s") or 0.0),
                                     str(r.get("trace_id", ""))))
        slow = slow[:TRACE_SLOW_KEEP]
        if slow:
            out["trace_slow"] = [
                {k: r[k] for k in
                 ("trace_id", "role", "hop", "e2e_s", "ttft_s",
                  "queue_s", "prefill_s", "first_decode_s",
                  "finish_reason", "failover_count", "preemptions",
                  "tokens_relayed")
                 if r.get(k) is not None}
                for r in slow]

    # -- router rollup ---------------------------------------------------
    routers = [s for s in streams if s.last_router is not None
               or s.router_events]
    if routers:
        out["routers"] = len(routers)
        windows = [s.last_router for s in routers
                   if s.last_router is not None]
        for field in ("replicas", "replicas_healthy",
                      "fleet_queue_depth", "fleet_slots",
                      "evictions_total", "respawns_total",
                      "scale_ups_total", "scale_downs_total"):
            vals = [w.get(field) for w in windows]
            vals = [v for v in vals if v is not None]
            if vals:
                out[f"router_{field}"] = sum(vals)
        out["router_events_total"] = sum(s.router_events
                                         for s in routers)
        last = max((s.last_router_event for s in routers
                    if s.last_router_event is not None),
                   key=lambda r: r.get("time", 0) or 0, default=None)
        if last is not None:
            out["router_last_event"] = str(last.get("event", ""))

    # -- error-budget / SLO rollup ---------------------------------------
    # Latest obs_slo record per (stream, slo name): worst budget
    # across the fleet, max burn rates, firing/page totals, probe
    # tallies, and the burn sparkline + last failed probe trace the
    # dashboard's error-budget panel renders.
    slo_streams = [s for s in streams if s.slo_last]
    if slo_streams:
        out["fleet_slo_records_total"] = sum(s.slo_records
                                             for s in slo_streams)
        table: List[dict] = []
        worst = None          # (budget_remaining, stream, name)
        max_page = max_ticket = None
        firing = 0
        pages = tickets = 0
        probe_req = probe_fail = probe_mis = 0
        last_trace = ""
        for s in slo_streams:
            rows = [s.slo_last[n] for n in sorted(s.slo_last)]
            for r in rows:
                row = {"stream": s.key, "name": r.get("name"),
                       "sli": r.get("sli"),
                       "objective": r.get("objective")}
                for k in ("budget_remaining", "error_rate",
                          "page_burn_long", "page_burn_short",
                          "ticket_burn_long", "page_firing",
                          "ticket_firing", "pages_total",
                          "tickets_total"):
                    if r.get(k) is not None:
                        row[k] = r[k]
                table.append(row)
                b = r.get("budget_remaining")
                if b is not None and (worst is None or b < worst[0]):
                    worst = (b, s.key, str(r.get("name")))
                pb, tb = (r.get("page_burn_long"),
                          r.get("ticket_burn_long"))
                if pb is not None:
                    max_page = pb if max_page is None \
                        else max(max_page, pb)
                if tb is not None:
                    max_ticket = tb if max_ticket is None \
                        else max(max_ticket, tb)
                if r.get("page_firing") or r.get("ticket_firing"):
                    firing += 1
                pages += int(r.get("pages_total") or 0)
                tickets += int(r.get("tickets_total") or 0)
                if r.get("last_failed_trace"):
                    last_trace = str(r["last_failed_trace"])
            # Probe tallies are engine-level and duplicated on every
            # SLO's record within a stream: count them once per
            # stream (max over that stream's records), sum over
            # streams.
            probe_req += max((int(r.get("probe_requests") or 0)
                              for r in rows), default=0)
            probe_fail += max((int(r.get("probe_failures") or 0)
                               for r in rows), default=0)
            probe_mis += max((int(r.get("probe_mismatches") or 0)
                              for r in rows), default=0)
        if worst is not None:
            out["fleet_slo_worst_budget_remaining"] = worst[0]
            out["fleet_slo_worst_slo"] = f"{worst[1]}:{worst[2]}"
        if max_page is not None:
            out["fleet_slo_max_page_burn"] = max_page
        if max_ticket is not None:
            out["fleet_slo_max_ticket_burn"] = max_ticket
        out["fleet_slo_firing"] = firing
        out["fleet_slo_pages_total"] = pages
        out["fleet_slo_tickets_total"] = tickets
        if probe_req:
            out["fleet_slo_probe_requests_total"] = probe_req
            out["fleet_slo_probe_failures_total"] = probe_fail
            out["fleet_slo_probe_mismatches_total"] = probe_mis
        if last_trace:
            out["fleet_slo_last_failed_trace"] = last_trace
        out["slo_table"] = table
        # Burn sparkline: the worst-budget stream's recent
        # page-burn-rate history (values only, oldest first).
        spark_stream = slo_streams[0]
        if worst is not None:
            for s in slo_streams:
                if s.key == worst[1]:
                    spark_stream = s
                    break
        out["slo_burn_spark"] = [round(float(b), 4) for _, b
                                 in list(spark_stream.slo_burn)]

    # -- per-stream table ------------------------------------------------
    for s in streams:
        row: dict = {"stream": s.key, "records": s.records,
                     "alerts": s.alerts}
        if s.crashes:
            row["crashes"] = s.crashes
        if s.elastic_events:
            row["elastic_events"] = s.elastic_events
            if s.last_elastic is not None:
                row["elastic_last_event"] = str(
                    s.last_elastic.get("event", ""))
        row.update(s.identity)
        if s.last_epoch is not None:
            row["epoch"] = s.last_epoch.get("epoch")
            row["step"] = s.last_step()
            p50 = s.step_time_p50()
            if p50 is not None:
                row["step_time_p50_s"] = round(p50, 6)
            thr = s.throughput()
            if thr is not None:
                row[f"{thr[1]}_per_sec"] = thr[0]
            if s.last_epoch.get("mfu") is not None:
                row["mfu"] = s.last_epoch["mfu"]
            if s.mem_peaks:
                row["peak_bytes_in_use"] = s.mem_peaks[-1][1]
        if s.last_router is not None:
            rt = s.last_router
            for field in ("replicas", "replicas_healthy",
                          "fleet_queue_depth", "evictions_total",
                          "respawns_total"):
                if rt.get(field) is not None:
                    row[f"router_{field}"] = rt[field]
            if s.last_router_event is not None:
                row["router_last_event"] = str(
                    s.last_router_event.get("event", ""))
        if s.slo_last:
            budgets = [(r.get("budget_remaining"), n)
                       for n, r in s.slo_last.items()
                       if r.get("budget_remaining") is not None]
            if budgets:
                b, n = min(budgets)
                row["slo_worst_budget_remaining"] = b
                row["slo_worst"] = n
            if any(r.get("page_firing") or r.get("ticket_firing")
                   for r in s.slo_last.values()):
                row["slo_firing"] = 1
        if s.last_serve is not None:
            sv = s.last_serve
            for field in ("queue_depth", "active_slots", "slots",
                          "requests_total", "requests_rejected"):
                if sv.get(field) is not None:
                    row[f"serve_{field}"] = sv[field]
            if sv.get("requests_total"):
                row["serve_reject_rate"] = round(
                    (sv.get("requests_rejected") or 0)
                    / sv["requests_total"], 4)
            for key in ("ttft_p50_s", "e2e_p99_s"):
                if sv.get(key) is not None:
                    row[f"serve_{key}"] = sv[key]
        per_stream.append(row)
    out["per_stream"] = per_stream
    return out
