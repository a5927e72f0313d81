"""End-to-end request tracing across the serve tier.

A copy of ``tpunet/obs/tracing.py`` (framework-free): the trace headers,
breadcrumbs and ``obs_trace`` records are the JAX package's, so a port
replica joins the same traces behind the same router.

One request now crosses up to three processes — the router frontend,
the replica that started the stream, and (under mid-stream failover,
docs/serving.md) the survivor that finished it. This module is the
shared vocabulary that lets all of them talk about the SAME request:

- **trace id** — 16 lowercase hex chars, minted by the router (or
  adopted from a client-supplied ``X-Trace-Id``), carried on every
  replica hop via headers, including failover re-submits carrying
  ``resume_tokens``.
- **hop** — which process span a breadcrumb belongs to: hop 0 is the
  router relay, hop 1 the first replica attempt, each re-open (route
  retry or failover re-submit) increments. ``(trace_id, hop)`` is
  globally unique; per-process request ids are not.
- **breadcrumbs** — ``trace``-kind flight-recorder ring events
  (``crumb()``), one per phase transition. The ring slot caps ``msg``
  at 80 bytes, so crumbs are a compact ``verb id hop k=v ...`` line.
  ``obs/history/timeline.py`` JOINs them across a router ring plus N
  replica rings into one causal track per trace.
- **``obs_trace`` records** — one flat per-hop span summary
  (docs/metrics_schema.md) emitted at request finish: queue / prefill
  / first-decode decomposition, preemption count and wall, the
  failover seam (``tokens_relayed``), finish reason. The fleet
  aggregator digests them into ``fleet_trace_*`` SLO decomposition
  and a slow-request exemplar list.

Cost discipline: tracing is head-sampled at the router
(``--trace-sample``; a client-supplied ``X-Trace-Id`` is always
sampled — explicit opt-in). An unsampled request carries an empty
``trace_id`` through the serve path and every call site short-circuits
on that one truthiness check, keeping the default path inside the
existing observability overhead gate (scripts/check_obs_overhead.py).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from tpunet_torch.obs import flightrec

#: Wire format (docs/metrics_schema.md "Trace wire format"): the
#: router stamps all three on every replica hop; clients may supply
#: ``X-Trace-Id`` to force-sample one request.
TRACE_HEADER = "X-Trace-Id"
SAMPLED_HEADER = "X-Trace-Sampled"
HOP_HEADER = "X-Trace-Hop"

_ID_RE = re.compile(r"[0-9a-f]{8,32}\Z")


def mint_trace_id() -> str:
    """A fresh 16-hex trace id (64 random bits — collision-safe for
    any realistic request volume, small enough for an 80-byte ring
    slot next to a verb and a hop)."""
    return os.urandom(8).hex()


def valid_trace_id(value) -> bool:
    """Accept 8-32 lowercase hex chars — our own ids plus common
    external formats (W3C trace ids are 32 hex). Anything else is
    rejected so a hostile header can't pollute rings or records."""
    return isinstance(value, str) and bool(_ID_RE.fullmatch(value))


def should_sample(rate: float, trace_id: str) -> bool:
    """Deterministic head-based sampling: hash the id's first 8 hex
    chars into [0, 1). Every process that sees the same id makes the
    same call — no coin-flip disagreement between hops."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) / 0x100000000 < rate


def crumb(verb: str, trace_id: str, hop: int, **fields) -> None:
    """One ``trace``-kind ring breadcrumb: ``verb id hop k=v ...``.
    No-op when no recorder is armed (flightrec.record contract).
    Callers guard on ``trace_id`` truthiness so unsampled requests
    pay one attribute read, not a string build."""
    extra = "".join(f" {k}={v}" for k, v in fields.items())
    flightrec.record("trace", f"{verb} {trace_id} {hop}{extra}")


def parse_crumb(msg: str) -> Optional[dict]:
    """Invert ``crumb()`` for the timeline join: ``{"verb", "trace_id",
    "hop", <k: v strings>}`` or None for a malformed line."""
    parts = msg.split()
    if len(parts) < 3 or not parts[2].isdigit():
        return None
    out = {"verb": parts[0], "trace_id": parts[1],
           "hop": int(parts[2])}
    for kv in parts[3:]:
        k, sep, v = kv.partition("=")
        if sep:
            out[k] = v
    return out


def build_trace_record(*, trace_id: str, hop: int, role: str,
                       finish_reason: str,
                       queue_s: Optional[float] = None,
                       prefill_s: Optional[float] = None,
                       prefill_bucket: Optional[int] = None,
                       first_decode_s: Optional[float] = None,
                       tokens: int = 0,
                       preemptions: int = 0,
                       preempt_wall_s: Optional[float] = None,
                       resume_offset: int = 0,
                       failover_count: int = 0,
                       tokens_relayed: Optional[int] = None,
                       ttft_s: Optional[float] = None,
                       e2e_s: Optional[float] = None,
                       error: str = "") -> dict:
    """One flat ``obs_trace`` record (docs/metrics_schema.md) — the
    per-hop span summary. Module-level and engine-free so the
    schema-conformance check (scripts/check_metrics_schema.py) drives
    the exact shape without standing up a server. ``role`` is
    ``router`` (relay span: e2e, failover seam) or ``replica``
    (compute span: queue/prefill/decode decomposition)."""
    if role not in ("router", "replica"):
        raise ValueError(f"role must be router|replica, got {role!r}")
    record: dict = {"trace_id": trace_id, "hop": int(hop),
                    "role": role, "finish_reason": finish_reason,
                    "tokens": int(tokens)}
    for key, val, nd in (("queue_s", queue_s, 6),
                         ("prefill_s", prefill_s, 6),
                         ("first_decode_s", first_decode_s, 6),
                         ("preempt_wall_s", preempt_wall_s, 6),
                         ("ttft_s", ttft_s, 6),
                         ("e2e_s", e2e_s, 6)):
        if val is not None:
            record[key] = round(float(val), nd)
    if prefill_bucket is not None:
        record["prefill_bucket"] = int(prefill_bucket)
    if preemptions:
        record["preemptions"] = int(preemptions)
    if resume_offset:
        record["resume_offset"] = int(resume_offset)
    if failover_count:
        record["failover_count"] = int(failover_count)
    if tokens_relayed is not None:
        record["tokens_relayed"] = int(tokens_relayed)
    if error:
        record["error"] = str(error)[:200]
    return record


def observe_trace(reg, record: dict) -> None:
    """Bump the ``trace_*`` registry instruments from one record —
    sampled-request counts plus the phase histograms the fleet SLO
    decomposition quantiles come from."""
    reg.counter("trace_requests_total").inc()
    for key in ("queue_s", "prefill_s", "first_decode_s", "e2e_s"):
        val = record.get(key)
        if val is not None:
            reg.histogram(f"trace_{key}").observe(float(val))
