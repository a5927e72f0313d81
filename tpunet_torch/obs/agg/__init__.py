"""Fleet observability: merge N runs' record streams into one view.

PRs 1-2 gave one run a record stream, a watchdog, and a dashboard;
serving added per-replica ``obs_serve`` SLOs. This package is the
cross-stream layer — the MegaScale-style jump from per-host logs to
fleet-level straggler and skew detection:

- ``receiver``  — ``Aggregator``: thread-safe ingest of N concurrent
  streams (ndjson POSTs relayed by the dashboard's ``--listen`` mode,
  or offline replay of metrics.jsonl files), routed into per-stream
  digests by the ``run_id``/``process_index`` identity stamp.
- ``merge``     — the cross-stream math: counts/means merge exactly;
  percentiles merge through each stream's exported bounded sample
  with a documented rank-error bound (DKW + export striding).
- ``rollup``    — per-stream digests and the fleet rollup: merged
  step-time distribution, step-aligned straggler factor, memory
  growth trend, summed throughput, and the aggregated serve SLO view.
- ``alerts``    — ``AlertBridge``: straggler / stale-stream /
  mem-growth built-ins plus operator ``GaugePredicate`` rules, fired
  per-stream and fleet-wide as the existing ``obs_alert`` kind.

``python -m tpunet_torch.obs.cli.dashboard`` (the counterpart of
``scripts/obs_dashboard.py``, same flags and output) grows a fleet mode
on top (multiple metrics.jsonl paths, or ``--listen --fleet``); record
kinds and fields are documented in docs/metrics_schema.md.

A copy of ``tpunet/obs/agg/`` with its imports pointed at the port, so
the card's host, which has no JAX, runs it.
"""

from __future__ import annotations

from tpunet_torch.obs.agg.alerts import AlertBridge
from tpunet_torch.obs.agg.receiver import Aggregator, stream_key
from tpunet_torch.obs.agg.rollup import StreamState, fleet_rollup

__all__ = ["Aggregator", "AlertBridge", "StreamState", "fleet_rollup",
           "stream_key"]
