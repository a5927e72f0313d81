"""SLO engine: declarative objectives, error budgets, burn-rate paging.

A copy of ``tpunet/obs/slo.py`` (stdlib only): the same policy format,
verdicts, burn rates and records, so the port's router pages as the JAX
package's does.

The observability stack before this module was entirely passive — it
records TTFT/e2e/trace quantiles, regressions and crashes after the
fact, but nothing STATES a target, tracks an error budget against it,
or pages while the budget is still burning. This module closes that
loop for the serve tier:

- **Policy** (``docs/slos.json`` / ``load_policy``): declarative SLO
  definitions — an SLI (availability, TTFT/e2e latency-vs-threshold,
  probe correctness), an objective (e.g. 0.99), a compliance window,
  and per-severity burn-rate alert rules.
- **SLI streams**: bounded in-memory event series the router (and its
  synthetic prober, tpunet_torch/router/prober.py) feed — request
  outcomes, latency samples, probe verdicts. Everything is evaluated
  from the SAME streams, so passive traffic and canary probes share one budget.
- **Multi-window multi-burn-rate evaluation** (Google-SRE style): a
  rule fires only when the burn rate — observed error rate divided by
  the budget rate ``1 - objective`` — exceeds its threshold over BOTH
  a long and a short window. The long window gives the page
  significance (a real burn, not one unlucky minute); the short
  window gives it a fast reset (recovery stops paging within
  ``short_s``, not ``long_s``). ``page`` rules are the fast-burn
  "wake a human" tier; ``ticket`` rules the slow-burn "file a bug"
  tier.
- **Edge latching**: a rule pages once when it starts firing and
  re-arms when the condition clears — a sustained burn is one page,
  a relapse is a second one. Pages ride the existing ``obs_alert``
  kind (reasons ``slo_fast_burn`` / ``slo_slow_burn``), so the
  AlertWebhook delivery path (retry/backoff/dead-letter) works
  unchanged.
- **``obs_slo`` records** (docs/metrics_schema.md): one per SLO per
  emit window — budget remaining over the compliance window, burn
  rate per alert window, firing state, probe tallies, and the last
  failed probe's trace id (every failed probe points at a replayable
  trace).

Windows with no events yield NO verdict: a rule neither fires nor
clears on silence (an idle fleet is not an outage, and a wedged
prober must not clear an active page). Event timestamps are taken as
given — a skewed or replayed clock changes which window an event
lands in, never crashes the evaluator.
"""

from __future__ import annotations

import json
import re
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: SLI stream kinds a spec may target. ``availability`` and
#: ``correctness`` are good/bad count streams; the ``latency_*``
#: streams hold raw seconds judged against the spec's threshold.
SLIS = ("availability", "latency_ttft", "latency_e2e", "correctness")

#: Alert severities, in paging order.
SEVERITIES = ("page", "ticket")

#: Per-SLI event retention: enough for any realistic alert window at
#: probe cadence; under heavy passive traffic the oldest events age
#: out first, so the windows stay honest for recent traffic.
MAX_EVENTS = 4096


@dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate alert rule: fire when the burn rate
    exceeds ``burn`` over BOTH the long and the short window."""

    severity: str            # "page" (fast burn) | "ticket" (slow burn)
    long_s: float
    short_s: float
    burn: float


@dataclass(frozen=True)
class SloSpec:
    """One declarative SLO over one SLI stream."""

    name: str
    sli: str
    objective: float         # good fraction target in (0, 1)
    compliance_window_s: float
    threshold_s: Optional[float] = None   # latency_* SLIs only
    rules: Tuple[BurnRule, ...] = ()

    @property
    def budget(self) -> float:
        """The error budget rate: the bad fraction the objective
        tolerates (burn rate 1.0 = spending it exactly on time)."""
        return 1.0 - self.objective


#: The built-in default policy — same content as docs/slos.json (which
#: is the commented, operator-editable copy). Production-scale windows:
#: the classic 14.4x-over-1h fast burn (2% of a 30-day budget in an
#: hour) and 6x-over-6h slow burn.
DEFAULT_POLICY: dict = {
    "slos": [
        {"name": "availability", "sli": "availability",
         "objective": 0.99, "compliance_window_s": 2592000,
         "page": {"long_s": 3600, "short_s": 300, "burn": 14.4},
         "ticket": {"long_s": 21600, "short_s": 1800, "burn": 6.0}},
        {"name": "ttft", "sli": "latency_ttft", "objective": 0.99,
         "threshold_s": 1.5, "compliance_window_s": 2592000,
         "page": {"long_s": 3600, "short_s": 300, "burn": 14.4},
         "ticket": {"long_s": 21600, "short_s": 1800, "burn": 6.0}},
        {"name": "e2e_latency", "sli": "latency_e2e",
         "objective": 0.95, "threshold_s": 10.0,
         "compliance_window_s": 2592000,
         "page": {"long_s": 3600, "short_s": 300, "burn": 14.4},
         "ticket": {"long_s": 21600, "short_s": 1800, "burn": 6.0}},
        {"name": "correctness", "sli": "correctness",
         "objective": 0.999, "compliance_window_s": 2592000,
         "page": {"long_s": 600, "short_s": 60, "burn": 1.0}},
    ],
}


class SloPolicyError(ValueError):
    """A malformed policy file — loud at boot, never mid-incident."""


def _strip_comments(text: str) -> str:
    """Drop full-line ``//`` comments so docs/slos.json can explain
    itself to operators (stdlib json has no comment support; only
    whole-line comments are stripped — ``//`` inside string values,
    e.g. URLs, is never touched)."""
    return "\n".join("" if re.match(r"\s*//", line) else line
                     for line in text.splitlines())


def _parse_spec(raw: dict) -> SloSpec:
    name = str(raw.get("name") or "")
    if not re.fullmatch(r"[a-z0-9_]+", name):
        raise SloPolicyError(
            f"slo name must be lowercase [a-z0-9_]+, got {name!r}")
    sli = str(raw.get("sli") or "")
    if sli not in SLIS:
        raise SloPolicyError(
            f"slo {name!r}: sli must be one of {SLIS}, got {sli!r}")
    try:
        objective = float(raw["objective"])
    except (KeyError, TypeError, ValueError):
        raise SloPolicyError(f"slo {name!r}: missing numeric objective")
    if not 0.0 < objective < 1.0:
        raise SloPolicyError(
            f"slo {name!r}: objective must be in (0, 1), got {objective}")
    window = float(raw.get("compliance_window_s") or 0)
    if window <= 0:
        raise SloPolicyError(
            f"slo {name!r}: compliance_window_s must be > 0")
    threshold = raw.get("threshold_s")
    if sli.startswith("latency_"):
        if threshold is None or float(threshold) <= 0:
            raise SloPolicyError(
                f"slo {name!r}: latency SLIs need threshold_s > 0")
        threshold = float(threshold)
    else:
        threshold = None
    rules = []
    for severity in SEVERITIES:
        rule = raw.get(severity)
        if rule is None:
            continue
        long_s = float(rule.get("long_s") or 0)
        short_s = float(rule.get("short_s") or 0)
        burn = float(rule.get("burn") or 0)
        if not 0 < short_s <= long_s:
            raise SloPolicyError(
                f"slo {name!r} {severity}: need 0 < short_s <= long_s")
        if burn <= 0:
            raise SloPolicyError(
                f"slo {name!r} {severity}: burn must be > 0")
        rules.append(BurnRule(severity, long_s, short_s, burn))
    if not rules:
        raise SloPolicyError(
            f"slo {name!r}: at least one of {SEVERITIES} required")
    return SloSpec(name=name, sli=sli, objective=objective,
                   compliance_window_s=window, threshold_s=threshold,
                   rules=tuple(rules))


def load_policy(path: str = "") -> Tuple[SloSpec, ...]:
    """Parse a policy file (``--slo-policy``) into specs; an empty
    path loads the built-in defaults (the same content docs/slos.json
    ships commented)."""
    if not path:
        raw = DEFAULT_POLICY
    else:
        with open(path) as f:
            text = _strip_comments(f.read())
        try:
            raw = json.loads(text)
        except ValueError as e:
            raise SloPolicyError(f"{path}: not valid JSON "
                                 f"(after //-comment strip): {e}")
    # tpunet's ``raw.get`` raises AttributeError on a JSON array or
    # scalar; the port refuses it as the malformed policy it is.
    slos = raw.get("slos") if isinstance(raw, dict) else None
    if not isinstance(slos, list) or not slos:
        raise SloPolicyError(
            f"{path or '<default>'}: policy needs a non-empty "
            "'slos' list")
    specs = tuple(_parse_spec(s) for s in slos)
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise SloPolicyError(f"duplicate slo names: {sorted(names)}")
    return specs


def build_slo_record(*, name: str, sli: str, objective: float,
                     compliance_window_s: float,
                     threshold_s: Optional[float] = None,
                     events: int = 0, bad: int = 0,
                     error_rate: Optional[float] = None,
                     budget_remaining: Optional[float] = None,
                     page_burn_long: Optional[float] = None,
                     page_burn_short: Optional[float] = None,
                     page_burn_threshold: Optional[float] = None,
                     page_window_long_s: Optional[float] = None,
                     page_window_short_s: Optional[float] = None,
                     page_firing: bool = False,
                     ticket_burn_long: Optional[float] = None,
                     ticket_burn_short: Optional[float] = None,
                     ticket_burn_threshold: Optional[float] = None,
                     ticket_window_long_s: Optional[float] = None,
                     ticket_window_short_s: Optional[float] = None,
                     ticket_firing: bool = False,
                     pages_total: int = 0, tickets_total: int = 0,
                     probe_requests: int = 0, probe_failures: int = 0,
                     probe_mismatches: int = 0,
                     last_failed_trace: str = "") -> dict:
    """One flat ``obs_slo`` record (docs/metrics_schema.md).
    Module-level and engine-free so the schema-conformance check
    (scripts/check_metrics_schema.py) drives the exact shape without
    standing up a router."""
    record: dict = {"name": name, "sli": sli,
                    "objective": round(float(objective), 6),
                    "compliance_window_s": float(compliance_window_s),
                    "events": int(events), "bad": int(bad)}
    if threshold_s is not None:
        record["threshold_s"] = round(float(threshold_s), 6)
    for key, val, nd in (("error_rate", error_rate, 6),
                         ("budget_remaining", budget_remaining, 6),
                         ("page_burn_long", page_burn_long, 4),
                         ("page_burn_short", page_burn_short, 4),
                         ("ticket_burn_long", ticket_burn_long, 4),
                         ("ticket_burn_short", ticket_burn_short, 4)):
        if val is not None:
            record[key] = round(float(val), nd)
    for key, val in (("page_burn_threshold", page_burn_threshold),
                     ("page_window_long_s", page_window_long_s),
                     ("page_window_short_s", page_window_short_s),
                     ("ticket_burn_threshold", ticket_burn_threshold),
                     ("ticket_window_long_s", ticket_window_long_s),
                     ("ticket_window_short_s", ticket_window_short_s)):
        if val is not None:
            record[key] = float(val)
    if page_firing:
        record["page_firing"] = 1
    if ticket_firing:
        record["ticket_firing"] = 1
    if pages_total:
        record["pages_total"] = int(pages_total)
    if tickets_total:
        record["tickets_total"] = int(tickets_total)
    if probe_requests:
        record["probe_requests"] = int(probe_requests)
        record["probe_failures"] = int(probe_failures)
        record["probe_mismatches"] = int(probe_mismatches)
    if last_failed_trace:
        record["last_failed_trace"] = last_failed_trace
    return record


class SloEngine:
    """SLI streams + the multi-window burn-rate evaluator.

    Feed it events (``note_request`` / ``note_latency`` /
    ``note_probe``), call ``evaluate()`` on the control-loop cadence:
    it updates the ``slo_*`` gauges, fires/clears edge-latched pages
    through the registry's ``obs_alert`` path, and returns the
    ``obs_slo`` record bodies (the caller owns emission cadence).
    Thread-safe for the router's handler-threads-feed /
    control-loop-evaluates split.
    """

    def __init__(self, specs, *, registry=None, clock=time.time,
                 max_events: int = MAX_EVENTS):
        import threading
        self.specs: Tuple[SloSpec, ...] = tuple(specs)
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        # One event deque per SLI actually targeted: count SLIs hold
        # (t, good, bad); latency SLIs hold (t, seconds).
        self._streams: Dict[str, deque] = {
            s.sli: deque(maxlen=max_events) for s in self.specs}
        # Longest window any spec evaluates per SLI — events older
        # than it are pruned on append.
        self._horizon: Dict[str, float] = {}
        for s in self.specs:
            windows = [s.compliance_window_s]
            windows += [r.long_s for r in s.rules]
            self._horizon[s.sli] = max(self._horizon.get(s.sli, 0.0),
                                       max(windows))
        self._latched: Dict[Tuple[str, str], bool] = {}
        self._pages: Dict[str, int] = {s.name: 0 for s in self.specs}
        self._tickets: Dict[str, int] = {s.name: 0 for s in self.specs}
        self.probe_requests = 0
        self.probe_failures = 0
        self.probe_mismatches = 0
        self.last_failed_trace = ""

    # -- feed side -------------------------------------------------------

    def _append(self, sli: str, event, t: float) -> None:
        q = self._streams.get(sli)
        if q is None:
            return             # no spec targets this SLI
        horizon = self._horizon.get(sli, 0.0)
        with self._lock:
            q.append(event)
            while q and q[0][0] < t - horizon:
                q.popleft()

    def note_request(self, ok: bool, t: Optional[float] = None) -> None:
        """One availability event: a request that completed (ok) or
        was rejected / errored out (not ok)."""
        t = self._clock() if t is None else t
        self._append("availability", (t, 0 if ok else 1), t)

    def note_latency(self, kind: str, seconds: float,
                     t: Optional[float] = None) -> None:
        """One latency sample for the ``latency_<kind>`` SLI
        (``kind`` is ``ttft`` or ``e2e``); judged against each
        targeting spec's own threshold at evaluate time."""
        t = self._clock() if t is None else t
        self._append(f"latency_{kind}", (t, float(seconds)), t)

    def note_correctness(self, ok: bool,
                         t: Optional[float] = None) -> None:
        t = self._clock() if t is None else t
        self._append("correctness", (t, 0 if ok else 1), t)

    def note_probe(self, *, ok: bool, mismatch: bool = False,
                   ttft_s: Optional[float] = None,
                   e2e_s: Optional[float] = None, trace_id: str = "",
                   t: Optional[float] = None) -> None:
        """One synthetic-prober verdict, fanned into every SLI stream:
        availability (did it answer), latency (how fast), correctness
        (were the tokens bitwise golden — only judgeable when it
        answered). A failed or wrong probe pins its trace id so the
        page that follows points at a replayable trace."""
        t = self._clock() if t is None else t
        self.probe_requests += 1
        self.note_request(ok, t=t)
        if ok:
            if ttft_s is not None:
                self.note_latency("ttft", ttft_s, t=t)
            if e2e_s is not None:
                self.note_latency("e2e", e2e_s, t=t)
            self.note_correctness(not mismatch, t=t)
        if not ok:
            self.probe_failures += 1
        if mismatch:
            self.probe_mismatches += 1
        if (not ok or mismatch) and trace_id:
            self.last_failed_trace = trace_id

    # -- evaluate side ---------------------------------------------------

    def _window_counts(self, spec: SloSpec, now: float,
                       window_s: float) -> Tuple[int, int]:
        """(events, bad) inside ``[now - window_s, ...]`` for one
        spec. Latency SLIs count a sample as bad when it exceeds the
        spec's threshold; future-stamped events (clock skew) land in
        every window rather than vanishing."""
        q = self._streams.get(spec.sli)
        if not q:
            return 0, 0
        lo = now - window_s
        total = bad = 0
        with self._lock:
            events = list(q)
        if spec.sli.startswith("latency_"):
            for t, seconds in events:
                if t >= lo:
                    total += 1
                    if seconds > spec.threshold_s:
                        bad += 1
        else:
            for t, is_bad in events:
                if t >= lo:
                    total += 1
                    bad += is_bad
        return total, bad

    def _burn(self, spec: SloSpec, now: float,
              window_s: float) -> Optional[float]:
        """Burn rate over one window: observed error rate / budget
        rate. None when the window holds no events (no verdict)."""
        total, bad = self._window_counts(spec, now, window_s)
        if total == 0:
            return None
        return (bad / total) / spec.budget

    def _fire(self, spec: SloSpec, rule: BurnRule, burn_long: float,
              burn_short: float, budget_remaining) -> None:
        reason = ("slo_fast_burn" if rule.severity == "page"
                  else "slo_slow_burn")
        if rule.severity == "page":
            self._pages[spec.name] += 1
        else:
            self._tickets[spec.name] += 1
        if self.registry is None:
            return
        self.registry.counter("slo_pages_total" if rule.severity
                              == "page" else "slo_tickets_total").inc()
        # Detail fields flat on the record, the obs_alert convention
        # every emitter follows (health.py, agg/alerts.py, orbax_io).
        record: dict = {
            "reason": reason, "severity": rule.severity, "step": 0,
            "slo": spec.name, "sli": spec.sli,
            "objective": spec.objective,
            "burn_long": round(burn_long, 4),
            "burn_short": round(burn_short, 4),
            "burn_threshold": rule.burn,
            "window_long_s": rule.long_s,
            "window_short_s": rule.short_s,
        }
        if budget_remaining is not None:
            record["budget_remaining"] = round(budget_remaining, 6)
        if self.last_failed_trace:
            record["trace_id"] = self.last_failed_trace
        self.registry.emit("obs_alert", record)

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass over every SLO: update gauges, fire or
        re-arm edge-latched pages, return the ``obs_slo`` record
        bodies. Idempotent between state changes — safe on every
        control-loop round."""
        now = self._clock() if now is None else now
        records = []
        for spec in self.specs:
            total, bad = self._window_counts(
                spec, now, spec.compliance_window_s)
            error_rate = bad / total if total else None
            budget_remaining = None
            if error_rate is not None:
                budget_remaining = max(
                    0.0, 1.0 - error_rate / spec.budget)
            fields: dict = {}
            for rule in spec.rules:
                burn_long = self._burn(spec, now, rule.long_s)
                burn_short = self._burn(spec, now, rule.short_s)
                sev = rule.severity
                fields[f"{sev}_burn_long"] = burn_long
                fields[f"{sev}_burn_short"] = burn_short
                fields[f"{sev}_burn_threshold"] = rule.burn
                fields[f"{sev}_window_long_s"] = rule.long_s
                fields[f"{sev}_window_short_s"] = rule.short_s
                key = (spec.name, sev)
                latched = self._latched.get(key, False)
                if burn_long is None or burn_short is None:
                    # Empty window: no verdict — the latch holds (an
                    # idle fleet is not an outage; a wedged prober
                    # must not clear an active page).
                    firing = latched
                else:
                    firing = (burn_long >= rule.burn
                              and burn_short >= rule.burn)
                    if firing and not latched:
                        self._fire(spec, rule, burn_long, burn_short,
                                   budget_remaining)
                    self._latched[key] = firing
                fields[f"{sev}_firing"] = firing
                if self.registry is not None and burn_long is not None:
                    self.registry.gauge(
                        f"slo_{spec.name}_{sev}_burn").set(
                        round(burn_long, 4))
            if self.registry is not None \
                    and budget_remaining is not None:
                self.registry.gauge(
                    f"slo_{spec.name}_budget_remaining").set(
                    round(budget_remaining, 6))
            records.append(build_slo_record(
                name=spec.name, sli=spec.sli, objective=spec.objective,
                compliance_window_s=spec.compliance_window_s,
                threshold_s=spec.threshold_s, events=total, bad=bad,
                error_rate=error_rate,
                budget_remaining=budget_remaining,
                pages_total=self._pages[spec.name],
                tickets_total=self._tickets[spec.name],
                probe_requests=self.probe_requests,
                probe_failures=self.probe_failures,
                probe_mismatches=self.probe_mismatches,
                last_failed_trace=self.last_failed_trace,
                **fields))
        return records
