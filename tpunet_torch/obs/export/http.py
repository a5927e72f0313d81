"""Line-JSON HTTP transport: POST one ``application/x-ndjson`` line
per record.

A copy of ``tpunet/obs/export/http.py`` (framework-free).

This is the full-fidelity path (nested fields survive, unlike statsd's
numeric flattening) and the one the dashboard's ``--listen`` mode
receives. Every request carries the socket timeout, so a dead or
black-holed endpoint costs at most ``timeout`` seconds *on the drain
thread* — the training thread only ever paid a queue put. Failures
raise to the caller (``AsyncExporter`` counts them).
"""

from __future__ import annotations

import json
import urllib.request


class HttpLineTransport:
    def __init__(self, url: str, timeout: float = 1.0):
        self.url = url
        self.timeout = timeout

    def send(self, record: dict) -> None:
        self.send_many([record])

    def send_many(self, records) -> None:
        """One POST for a whole queue backlog (receivers split on
        newline — ``obs_dashboard.py --listen`` does): per-request
        latency is paid per batch, not per record, so a fast producer
        with --obs-step-every 1 can't outrun the drain thread."""
        data = "".join(json.dumps(r) + "\n" for r in records).encode()
        req = urllib.request.Request(
            self.url, data=data, method="POST",
            headers={"Content-Type": "application/x-ndjson"})
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass

    def close(self) -> None:
        pass
