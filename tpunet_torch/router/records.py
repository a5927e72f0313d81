"""The ``obs_router`` record builders (docs/metrics_schema.md).

A copy of ``tpunet/router/records.py`` (stdlib only): the same
record shapes under the same keys.

Module-level and engine-free, like ``build_serve_record``: the
schema-conformance check (scripts/check_metrics_schema.py) drives the
exact record shapes without standing up a router. Two flavors share
the kind:

- **window records** (``build_router_record``) — periodic fleet
  state: cumulative counters + window histograms + per-replica rows.
  No ``event`` field; they never page.
- **event records** (``build_router_event``) — one per action the
  control loop (or the failover relay) takes (evict / respawn /
  scale_up / scale_down / failover). These carry ``event`` and DO
  page through the alert webhook (tpunet_torch/obs/export/webhook.py).
"""

from __future__ import annotations

import time
from typing import List, Optional

from tpunet_torch.router import replica as replica_states


def build_router_record(reg, *, replicas: List[dict], uptime_s: float,
                        window_s: float, scale_decision: str = "hold",
                        ttft_slo_burn: Optional[float] = None,
                        final: bool = False) -> dict:
    """One ``obs_router`` window record from the registry + the
    per-replica ``view()`` rows."""
    by_state = {}
    for row in replicas:
        by_state[row["state"]] = by_state.get(row["state"], 0) + 1
    healthy = [r for r in replicas
               if r["state"] == replica_states.HEALTHY]
    record = {
        "uptime_s": round(uptime_s, 3),
        "window_s": round(window_s, 3),
        "replicas": len(replicas),
        "replicas_healthy": by_state.get(replica_states.HEALTHY, 0),
        "replicas_draining": by_state.get(replica_states.DRAINING, 0),
        "replicas_dead": (by_state.get(replica_states.DEAD, 0)
                          + by_state.get(replica_states.EVICTED, 0)),
        "fleet_queue_depth": sum(r["queue_depth"] for r in healthy),
        "fleet_active_slots": sum(r["active_slots"] for r in healthy),
        "fleet_slots": sum(r["slots"] for r in healthy),
        "scale_decision": scale_decision,
    }
    for name in ("requests", "rerouted", "rejected", "affinity_hits",
                 "failovers", "evictions", "respawns", "scale_ups",
                 "scale_downs", "probe_failures"):
        record[f"{name}_total"] = int(
            reg.counter(f"router_{name}_total").value)
    if ttft_slo_burn is not None:
        record["ttft_slo_burn"] = round(ttft_slo_burn, 4)
    hist = reg.histogram("router_e2e_s")
    summ = hist.summary()
    for stat in ("p50", "p90", "p99", "mean"):
        if stat in summ:
            record[f"e2e_{stat}_s"] = round(summ[stat], 6)
    if summ:
        record["e2e_count"] = int(summ["count"])
        record["e2e_sample"] = [round(v, 6)
                                for v in hist.export_sample()]
        if summ.get("approx"):
            record["e2e_approx"] = 1
    record["per_replica"] = replicas
    if final:
        record["final"] = True
    return record


def build_router_event(event: str, *, replica: str = "",
                       url: str = "", cause: str = "",
                       old_replicas: Optional[int] = None,
                       new_replicas: Optional[int] = None,
                       detail: Optional[dict] = None) -> dict:
    """One ``obs_router`` action event (pages through the alert
    webhook). ``cause`` says what triggered it: ``probe_failures``,
    ``webhook:<reason>`` (an AlertWebhook page consumed on
    POST /webhook), or ``policy`` (an autoscale decision)."""
    record: dict = {"event": event, "severity": "warn",
                    "time": time.time()}
    if replica:
        record["replica"] = replica
    if url:
        record["url"] = url
    if cause:
        record["cause"] = cause
    if old_replicas is not None:
        record["old_replicas"] = old_replicas
    if new_replicas is not None:
        record["new_replicas"] = new_replicas
    if detail is not None:
        record["detail"] = detail
    return record
