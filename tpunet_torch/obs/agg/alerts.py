"""Fleet alert bridge: rollup state -> ``obs_alert`` records.

The per-run watchdog (tpunet_torch/obs/health.py) can only see one stream;
the failure modes that live *between* streams — a straggler replica, a
stream that stopped reporting, one host's memory creeping while the
others hold flat — are detected here, from the same rollup the
dashboard renders. Alerts reuse the existing ``obs_alert`` record kind
(one page feed, whatever the scope) with two extra routing fields:
``scope`` (``fleet`` | ``stream``) and ``stream`` (the offending
stream key, when there is one).

Built-in predicates are **edge-triggered with a latch**: a condition
fires once when it becomes true and re-arms only after it clears —
deterministic under replay (no step clock exists fleet-wide to hang a
cooldown off) and quiet under a condition that persists across many
rollups. Operator ``GaugePredicate`` rules are evaluated fleet-wide
against the flat rollup and per-stream against each stream's row,
with one predicate instance per target (growth rules keep state).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpunet_torch.obs.health import GaugePredicate


class AlertBridge:
    """Evaluates fleet predicates over successive rollups and emits
    ``obs_alert`` records through the aggregator's registry."""

    def __init__(self, registry, *, straggler_factor: float = 2.0,
                 stream_stale_s: float = 0.0,
                 mem_growth_bytes_per_epoch: float = 0.0,
                 rules=()):
        self.registry = registry
        self.straggler_factor = straggler_factor
        self.stream_stale_s = stream_stale_s
        self.mem_growth_bytes_per_epoch = mem_growth_bytes_per_epoch
        self._rule_specs = tuple(rules)
        # Validate eagerly — a typo'd rule should fail at construction,
        # not silently never fire.
        for spec in self._rule_specs:
            GaugePredicate.parse(spec)
        self._rule_insts: Dict[tuple, GaugePredicate] = {}
        self._latched: set = set()
        # Crash alerts are count-edge-triggered, not latched: every
        # rollup that sees a stream's obs_crash count advance pages
        # once, with the cumulative count in the detail — a
        # crash-looping replica keeps paging instead of latching
        # silent after its first crash.
        self._crash_seen: Dict[str, int] = {}
        self.alerts: List[dict] = []

    # -- emission --------------------------------------------------------

    def _fire(self, reason: str, *, scope: str, stream: str = "",
              detail: Optional[dict] = None, latch_key=None) -> None:
        key = latch_key or (reason, scope, stream)
        if key in self._latched:
            return
        self._latched.add(key)
        record = {"reason": reason, "step": 0, "severity": "warn",
                  "scope": scope}
        if stream:
            record["stream"] = stream
        if detail:
            record.update(detail)
        self.alerts.append(record)
        self.registry.counter("obs_alerts").inc()
        self.registry.emit("obs_alert", record)

    def _clear(self, reason: str, scope: str, stream: str = "",
               latch_key=None) -> None:
        self._latched.discard(latch_key or (reason, scope, stream))

    # -- evaluation ------------------------------------------------------

    def check(self, rollup: dict, streams,
              now: Optional[float] = None) -> List[dict]:
        """One rollup against every predicate; returns the alerts
        fired by THIS call (all alerts accumulate in ``self.alerts``
        and in the registry's sinks)."""
        fired_before = len(self.alerts)
        self._check_crashes(streams)
        self._check_straggler(rollup)
        self._check_mem_growth(streams)
        if now is not None and self.stream_stale_s > 0:
            self._check_stale(streams, now)
        self._check_rules(rollup, streams, now)
        return self.alerts[fired_before:]

    def _check_crashes(self, streams) -> None:
        """A stream whose ``obs_crash`` count advanced since the last
        rollup crashed (and restarted) in between: page once per such
        rollup, carrying the cumulative count and the latest crash
        summary the restarted run emitted (tpunet_torch/obs/flightrec/)."""
        for s in streams:
            seen = self._crash_seen.get(s.key, 0)
            if s.crashes <= seen:
                continue
            self._crash_seen[s.key] = s.crashes
            detail = {"count": s.crashes}
            last = s.last_crash or {}
            for field in ("cause", "signal", "report_path"):
                if last.get(field) is not None:
                    detail[field] = last[field]
            # Bypass the latch: the count edge IS the dedup.
            key = ("crash", s.key, s.crashes)
            self._fire("crash", scope="stream", stream=s.key,
                       detail=detail, latch_key=key)

    def _check_straggler(self, rollup: dict) -> None:
        factor = rollup.get("straggler_factor")
        if factor is None:
            return
        stream = rollup.get("slowest_stream", "")
        if factor > self.straggler_factor:
            # Latch per offending stream, and drop other streams'
            # straggler latches on a handoff: if replica B recovers
            # while replica C degrades (the factor never dipping below
            # threshold), C's page must not be eaten by B's latch.
            for key in [k for k in self._latched
                        if k[0] == "straggler" and k[1] != stream]:
                self._latched.discard(key)
            self._fire("straggler", scope="fleet", stream=stream,
                       latch_key=("straggler", stream), detail={
                           "step_time_p50_s":
                               rollup.get("slowest_step_time_p50_s"),
                           "fleet_median_s":
                               rollup.get("median_step_time_p50_s"),
                           "factor": factor,
                           "threshold": self.straggler_factor,
                       })
        else:
            for key in [k for k in self._latched
                        if k[0] == "straggler"]:
                self._latched.discard(key)

    def _check_mem_growth(self, streams) -> None:
        """Every stream is judged (and its latch cleared) on its OWN
        slope — judging only the fleet-worst would leave a recovered
        stream's latch set while a different stream is the current
        worst, silently eating its next real leak."""
        threshold = self.mem_growth_bytes_per_epoch
        if threshold <= 0:
            return
        for s in streams:
            slope = s.mem_growth_per_epoch()
            if slope is None:
                continue
            if slope > threshold:
                self._fire("mem_growth", scope="stream", stream=s.key,
                           detail={"slope_bytes_per_epoch":
                                   round(slope, 1),
                                   "threshold": threshold})
            else:
                self._clear("mem_growth", "stream", s.key)

    def _check_stale(self, streams, now: float) -> None:
        for s in streams:
            if s.last_seen is None:
                continue
            age = now - s.last_seen
            if age > self.stream_stale_s:
                self._fire("stream_stale", scope="stream",
                           stream=s.key, detail={
                               "age_s": round(age, 2),
                               "timeout_s": self.stream_stale_s})
            else:
                self._clear("stream_stale", "stream", s.key)

    def _check_rules(self, rollup: dict, streams,
                     now: Optional[float]) -> None:
        """Operator GaugePredicates, fleet-wide and per-stream. The
        snapshot a rule sees is the flat rollup (fleet) or the
        stream's per_stream row (stream) — the same numbers the
        dashboard shows, so a fired rule is always explainable from
        the screen."""
        if not self._rule_specs:
            return
        t = now if now is not None else 0.0
        rows = {r["stream"]: r for r in rollup.get("per_stream", [])}
        targets = [("fleet", "", rollup)]
        targets += [("stream", key, row) for key, row in rows.items()]
        for spec in self._rule_specs:
            for scope, stream, snapshot in targets:
                inst = self._rule_insts.get((spec, scope, stream))
                if inst is None:
                    inst = GaugePredicate.parse(spec)
                    self._rule_insts[(spec, scope, stream)] = inst
                detail = inst.evaluate(snapshot, t)
                latch = ("rule", spec, scope, stream)
                if detail is not None:
                    self._fire("gauge_predicate", scope=scope,
                               stream=stream, detail=detail,
                               latch_key=latch)
                else:
                    self._clear("gauge_predicate", scope, stream,
                                latch_key=latch)
