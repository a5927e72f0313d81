"""Alert webhook: page a human (or a router) when a run goes bad.

A copy of ``tpunet/obs/export/webhook.py`` (framework-free).

The record stream already carries the pages — ``obs_alert`` (watchdog
and fleet bridge: straggler / crash / thread_stalled / mem_growth /
...), ``obs_crash`` (flight-recorder post-mortems), and
``obs_regression`` (cross-run compare verdicts). This sink filters
that stream down to alert kinds and POSTs one templated JSON payload
per page to an operator-configured URL (``--obs-webhook``; Slack/
PagerDuty-style receivers take it directly, and
``tests/test_obs_webhook.py`` shows the stdlib receiver shape).

Delivery discipline mirrors ``AsyncExporter`` — a dead pager endpoint
must never stall a step — plus the retry story a *page* needs that a
gauge sample does not: a failed POST is retried with exponential
backoff (an alert is rare and valuable; a metrics line is neither),
and a page that exhausts its retries lands in a bounded **dead
letter** list (``dead_letters()``) and counts in
``webhook_dead_letter``, so "the pager was down during the incident"
is itself visible after the fact. The accounting identity still
holds: every payload handed to ``write`` is eventually counted
exactly once —

    enqueued == sent + send_errors + dropped

(send_errors == dead-lettered pages; retries that eventually succeed
count once, as sent, with attempts tallied in ``webhook_retries``).
The drain thread registers in the flight-recorder host-thread
registry (tpucheck R4) and flips idle/busy around delivery, so a
wedged webhook endpoint pages through ``thread_stalled`` like any
other stuck host thread.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import deque
from typing import Optional, Tuple

#: Record kinds that page. Everything else is dropped at write() for
#: the cost of one dict lookup — the "configured but idle" overhead
#: the obs budget gate measures. obs_elastic pages because a
#: membership change is operator-actionable (a shrink is capacity
#: loss; a quorum failure is an outage). obs_router pages on its
#: ACTION events only (evict/respawn/scale — records carrying an
#: ``event`` field); periodic window records are fleet state, not
#: pages, and are filtered in ``write``.
ALERT_KINDS = ("obs_alert", "obs_crash", "obs_regression",
               "obs_elastic", "obs_router")

_CLOSE = object()


def _summary_line(record: dict) -> str:
    """One human-readable line per page (the template a chat webhook
    renders); the full record rides in ``detail``."""
    kind = record.get("kind", "obs_alert")
    stream = record.get("stream") or record.get("run_id") or ""
    where = f" [{stream}]" if stream else ""
    if kind == "obs_crash":
        return (f"tpunet crash{where}: {record.get('cause', 'unknown')}"
                f" (report: {record.get('report_path', '?')})")
    if kind == "obs_regression":
        n = record.get("regressions", 0)
        return (f"tpunet regression{where}: {n} metric(s) regressed "
                f"comparing {record.get('run_b', '?')} against "
                f"{record.get('run_a', '?')}")
    if kind == "obs_router":
        event = record.get("event", "router")
        rep = record.get("replica")
        rep_s = f" {rep}" if rep else ""
        worlds = ""
        if record.get("old_replicas") is not None \
                or record.get("new_replicas") is not None:
            worlds = (f" replicas {record.get('old_replicas', '?')}->"
                      f"{record.get('new_replicas', '?')}")
        cause = record.get("cause")
        cause_s = f" ({cause})" if cause else ""
        return f"tpunet router {event}{where}:{rep_s}{worlds}{cause_s}"
    if kind == "obs_elastic":
        event = record.get("event", "elastic")
        worlds = ""
        if record.get("old_world") is not None \
                or record.get("new_world") is not None:
            worlds = (f" world {record.get('old_world', '?')}->"
                      f"{record.get('new_world', '?')}")
        gen = record.get("generation")
        gen_s = f" gen {gen}" if gen is not None else ""
        cause = record.get("cause")
        cause_s = f" ({cause})" if cause else ""
        return f"tpunet elastic {event}{where}:{worlds}{gen_s}{cause_s}"
    reason = record.get("reason", "alert")
    sev = record.get("severity", "warn")
    return f"tpunet {reason} [{sev}]{where} at step {record.get('step', 0)}"


def build_payload(record: dict, source: str = "tpunet") -> dict:
    """The documented webhook wire format (docs/metrics_schema.md
    "Alert webhook wire format"): flat routing fields + a rendered
    summary + the verbatim record."""
    payload = {
        "source": source,
        "kind": record.get("kind", "obs_alert"),
        "reason": record.get("reason",
                             "crash" if record.get("kind") == "obs_crash"
                             else record.get("event")
                             or record.get("verdict", "alert")),
        "severity": record.get("severity", "warn"),
        "summary": _summary_line(record),
        "detail": record,
    }
    for key in ("run_id", "process_index", "host", "scope", "stream"):
        if record.get(key) is not None:
            payload[key] = record[key]
    return payload


class WebhookTransport:
    """Stdlib JSON POST (one request per page). Raises on transport
    errors and non-2xx responses — retry/backoff policy belongs to the
    sink, not here."""

    def __init__(self, url: str, timeout: float = 2.0):
        if not url.startswith(("http://", "https://")):
            raise ValueError(
                f"--obs-webhook expects an http(s):// URL, got {url!r}")
        self.url = url
        self.timeout = timeout

    def send(self, payload: dict) -> None:
        import urllib.request
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            status = getattr(resp, "status", 200)
            if status >= 300:
                raise IOError(f"webhook endpoint returned {status}")


class AlertWebhook:
    """Registry sink: alert-kind records -> templated JSON POSTs.

    ``write`` never blocks or raises (non-alert kinds cost one dict
    lookup; alert kinds one payload build + ``put_nowait``). The
    daemon drain thread owns delivery: per-page retries with
    exponential backoff (``backoff_s * 2**attempt``, capped), then
    the dead-letter list. ``close`` flushes in order, bounded by
    ``flush_timeout`` — a wedged pager cannot wedge shutdown, and the
    abandoned backlog is counted as dropped (identity preserved).
    """

    DEAD_LETTER_KEEP = 64

    def __init__(self, transport, *, name: str = "webhook",
                 queue_size: int = 64, max_retries: int = 3,
                 backoff_s: float = 0.25, backoff_cap_s: float = 5.0,
                 flush_timeout: float = 5.0, registry=None,
                 kinds: Tuple[str, ...] = ALERT_KINDS,
                 source: str = "tpunet"):
        if isinstance(transport, str):
            transport = WebhookTransport(transport)
        if queue_size < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size}")
        self.name = name
        self.kinds = tuple(kinds)
        self.source = source
        self._transport = transport
        self._send = transport.send
        self._max_retries = max_retries
        self._backoff_s = backoff_s
        self._backoff_cap_s = backoff_cap_s
        self._flush_timeout = flush_timeout
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._enqueued = 0
        self._sent = 0
        self._errors = 0
        self._closed = False
        self._abandoned = threading.Event()
        self._acct = threading.Lock()
        self.dead: deque = deque(maxlen=self.DEAD_LETTER_KEEP)
        if registry is not None:
            self._dropped = registry.counter("webhook_dropped")
            self._retries = registry.counter("webhook_retries")
            self._dead_ctr = registry.counter("webhook_dead_letter")
            self._sent_gauge = registry.gauge("webhook_sent")
            self._err_gauge = registry.gauge("webhook_send_errors")
        else:
            from tpunet_torch.obs.registry import Counter, Gauge
            self._dropped = Counter()
            self._retries = Counter()
            self._dead_ctr = Counter()
            self._sent_gauge = Gauge()
            self._err_gauge = Gauge()
        from tpunet_torch.obs.flightrec import register_thread
        self._handle = register_thread(f"webhook-{name}"
                                       if name != "webhook" else name,
                                       stall_after_s=60.0)
        self._thread = threading.Thread(
            target=self._drain, name=f"tpunet-webhook-{name}",
            daemon=True)
        self._thread.start()

    # -- producer side ---------------------------------------------------

    def write(self, record: dict) -> None:
        """Registry-sink entry point; never blocks, never raises.
        Non-alert kinds are filtered here, before any queue work."""
        if record.get("kind") not in self.kinds:
            return
        if record.get("kind") == "obs_router" \
                and not record.get("event"):
            return        # periodic window record, not a page
        if self._closed:
            self._dropped.inc()
            return
        try:
            self._q.put_nowait(build_payload(record, self.source))
            self._enqueued += 1
        except queue.Full:
            self._dropped.inc()

    def stats(self) -> dict:
        return {
            "enqueued": self._enqueued,
            "sent": self._sent,
            "send_errors": self._errors,
            "dropped": int(self._dropped.value),
            "retries": int(self._retries.value),
            "dead_letter": int(self._dead_ctr.value),
        }

    def dead_letters(self) -> list:
        """The most recent pages that exhausted their retries (bounded
        — post-incident evidence, not a redelivery queue)."""
        return list(self.dead)

    def close(self) -> None:
        """Flush and stop: pages written before this call are
        delivered (or dead-lettered) in order, bounded by
        ``flush_timeout``."""
        if self._closed:
            return
        self._closed = True
        try:
            self._q.put(_CLOSE, timeout=self._flush_timeout)
        except queue.Full:
            pass
        self._thread.join(self._flush_timeout)
        if self._thread.is_alive():
            # Same abandoned-backlog handoff as AsyncExporter.close:
            # the event also cuts any in-flight backoff sleep short.
            with self._acct:
                self._abandoned.set()
                undelivered = (self._enqueued - self._sent
                               - self._errors)
            if undelivered > 0:
                self._dropped.inc(undelivered)

    # -- drain side ------------------------------------------------------

    def _deliver(self, payload: dict) -> None:
        """One page: send with retry/backoff; ends in exactly one of
        sent / dead-letter."""
        attempt = 0
        while True:
            if self._abandoned.is_set():
                return             # counted as dropped by close()
            try:
                self._send(payload)
                with self._acct:
                    if not self._abandoned.is_set():
                        self._sent += 1
                self._sent_gauge.set(self._sent)
                return
            except Exception as e:
                if attempt >= self._max_retries:
                    with self._acct:
                        if self._abandoned.is_set():
                            return
                        self._errors += 1
                    self._err_gauge.set(self._errors)
                    self._dead_ctr.inc()
                    self.dead.append({"payload": payload,
                                      "error": str(e),
                                      "attempts": attempt + 1})
                    return
                self._retries.inc()
                delay = min(self._backoff_s * (2 ** attempt),
                            self._backoff_cap_s)
                attempt += 1
                # Interruptible backoff: close() setting the abandoned
                # flag wakes the wait instead of serving it out.
                if self._abandoned.wait(delay):
                    return

    def _drain(self) -> None:
        while True:
            self._handle.beat("idle")
            item = self._q.get()
            self._handle.beat("busy")
            if item is _CLOSE:
                self._handle.beat("idle")
                return
            self._deliver(item)
