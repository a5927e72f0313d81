"""Live telemetry export: push finished obs records off-host while the
run is live. A copy of ``tpunet/obs/export/`` (framework-free); only the
coordinator test asks the port's process group.

The contract that shapes everything here: **a slow or dead endpoint
must never stall a training step.** Sinks attached to the registry are
called synchronously from the step/epoch path, so the only exporter
the trainer ever sees is ``AsyncExporter`` — a bounded in-memory queue
whose ``write`` is a single non-blocking ``put_nowait``; a background
thread drains the queue into the actual transport (StatsD/UDP,
line-JSON HTTP, or anything with a ``send``/``write`` method). When
the queue is full the record is dropped *and counted* in the registry
(``export_<name>_dropped``) — never silently; transport failures are
likewise counted (``export_<name>_send_errors``), so

    records written == sent + send_errors + dropped

accounts for every record that entered ``write`` (overflow and
flush-timeout losses both land in ``dropped``; the internal
``enqueued`` tally in ``stats()`` counts only the writes that made it
into the queue, i.e. ``written - overflow_drops``).

Exporters are coordinator-only by construction (``build_exporters``):
one process speaks for the run, mirroring MetricsLogger's jsonl
discipline, so a pod doesn't report N copies of every record.
"""

from __future__ import annotations

from tpunet_torch.obs.export.exporter import AsyncExporter, MemoryTransport
from tpunet_torch.obs.export.http import HttpLineTransport
from tpunet_torch.obs.export.statsd import StatsdTransport
from tpunet_torch.obs.export.webhook import (AlertWebhook, WebhookTransport,
                                       build_payload)

__all__ = [
    "AlertWebhook", "AsyncExporter", "HttpLineTransport",
    "MemoryTransport", "StatsdTransport", "WebhookTransport",
    "build_exporters", "build_payload",
]


def build_exporters(cfg, registry) -> list:
    """Construct the configured exporters (``ExportConfig``) on the
    coordinator process; worker processes and an endpoint-less config
    get an empty list. Bad endpoint *syntax* raises here, at setup,
    where a config error should fail loudly — endpoint *liveness* is
    never checked (a down collector is the normal case the async queue
    exists for)."""
    from tpunet_torch.parallel.dist import process_index

    out: list = []
    if process_index() != 0:
        return out
    if getattr(cfg, "statsd", ""):
        host, _, port = cfg.statsd.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"--statsd expects HOST:PORT, got {cfg.statsd!r}")
        out.append(AsyncExporter(
            StatsdTransport(host, int(port), prefix=cfg.statsd_prefix),
            name="statsd", queue_size=cfg.queue_size,
            flush_timeout=cfg.flush_timeout_s, registry=registry))
    if getattr(cfg, "http", ""):
        if not cfg.http.startswith(("http://", "https://")):
            raise ValueError(
                f"--obs-http expects an http(s):// URL, got {cfg.http!r}")
        out.append(AsyncExporter(
            HttpLineTransport(cfg.http, timeout=cfg.http_timeout_s),
            name="http", queue_size=cfg.queue_size,
            flush_timeout=cfg.flush_timeout_s, registry=registry))
    if getattr(cfg, "webhook", ""):
        # URL syntax validated in WebhookTransport (same fail-at-setup
        # posture as the endpoints above).
        out.append(AlertWebhook(
            WebhookTransport(cfg.webhook, timeout=cfg.http_timeout_s),
            max_retries=cfg.webhook_max_retries,
            backoff_s=cfg.webhook_backoff_s,
            flush_timeout=cfg.flush_timeout_s, registry=registry))
    return out
