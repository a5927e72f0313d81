"""Run-health watchdog: turn the obs record stream into pages.

A copy of ``tpunet/obs/health.py`` (framework-free); its thread
registry is the port's ``tpunet_torch.obs.flightrec``.

The watchdog rides the same host-side observations the registry
already collects — no extra device syncs, no new collectives — and
emits ``obs_alert`` records (through ``Registry.emit``, so they reach
metrics.jsonl AND every live exporter) when a run goes bad in one of
the ways that actually burn walltime:

- **step stall**: a step takes ``stall_factor``x the rolling median of
  recent steps (and at least ``stall_min_s`` — compile-scale blips on
  millisecond steps are not incidents).
- **nan loss / loss spike**: a non-finite loss, or a loss above
  ``loss_spike_factor``x its warmed-up EMA (the divergence shape that
  precedes NaN by a few hundred steps).
- **stale heartbeat / missing processes**: no heartbeat inside
  ``heartbeat_timeout_s`` (a wedged epoch), or an epoch heartbeat
  counting fewer live processes than the pod started with.
- **thread stalled**: a background thread registered in the host-
  thread registry (``tpunet_torch/obs/flightrec/threads.py`` — orbax async
  writer, exporter drain, native prefetcher, serve engine) has been
  ``busy`` past its declared stall budget — per-thread attribution
  for "the host runtime is wedged", with per-thread cooldown keys so
  two stalled threads are two pages.

Alerts are per-reason rate-limited (``alert_cooldown_steps``) so a
stalled input pipeline pages once, not once per step; suppressed
repeats still count (``obs_alerts_suppressed``). With
``halt_on_unhealthy`` a fatal alert raises ``RunUnhealthyError`` after
the record is emitted — the record always lands first, so the
post-mortem shows *why* the run stopped.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Optional


class GaugePredicate:
    """Alert rule over any exported gauge / snapshot key.

    The watchdog's built-in predicates cover the failure shapes we
    could name in advance; these cover the ones the operator names at
    launch time (``--obs-rule``), and the fleet aggregator evaluates
    the same rules per-stream and fleet-wide. Three rule forms, one
    spec grammar::

        serve_queue_depth > 10        # fire while above a threshold
        mfu < 0.3                     # fire while below
        bytes_in_use + 1e6 / s        # fire when the least-squares
                                      # growth rate exceeds 1e6 per
                                      # second (leak shape)

    Threshold rules are stateless; growth rules keep a bounded
    ``(t, value)`` series per predicate instance, so evaluate one
    instance per stream (the aggregator does). ``evaluate`` returns a
    detail dict when the rule fires, else None — alert routing
    (cooldown, halt, emission) belongs to the caller.
    """

    # NAME > VALUE | NAME < VALUE | NAME + VALUE / s
    _SPEC = re.compile(
        r"^\s*([A-Za-z_][A-Za-z0-9_.]*)\s*"
        r"(?:([<>])\s*([-+0-9.eE]+)"
        r"|\+\s*([-+0-9.eE]+)\s*/\s*s)\s*$")

    WINDOW = 32          # growth-rule series bound
    MIN_POINTS = 3       # growth needs a trend, not two samples

    def __init__(self, name: str, *, above: Optional[float] = None,
                 below: Optional[float] = None,
                 grow_per_s: Optional[float] = None,
                 fatal: bool = False, spec: str = ""):
        if sum(x is not None for x in (above, below, grow_per_s)) != 1:
            raise ValueError(
                "exactly one of above/below/grow_per_s is required")
        self.name = name
        self.above = above
        self.below = below
        self.grow_per_s = grow_per_s
        self.fatal = fatal
        self.spec = spec or self._render_spec()
        self._series: deque = deque(maxlen=self.WINDOW)

    def _render_spec(self) -> str:
        if self.above is not None:
            return f"{self.name} > {self.above:g}"
        if self.below is not None:
            return f"{self.name} < {self.below:g}"
        return f"{self.name} + {self.grow_per_s:g}/s"

    @classmethod
    def parse(cls, spec: str, *, fatal: bool = False) -> "GaugePredicate":
        def bad():
            return ValueError(
                f"bad gauge rule {spec!r} (expected 'NAME > N', "
                f"'NAME < N', or 'NAME + N/s')")

        m = cls._SPEC.match(spec)
        if not m:
            raise bad()
        name, cmp_op, threshold, rate = m.groups()
        try:
            # The numeric charset is permissive ("1e", "+-3" match);
            # float() is the real validator — fold its failure into
            # the one diagnostic every malformed rule gets.
            value = float(rate if rate is not None else threshold)
        except ValueError:
            raise bad() from None
        if rate is not None:
            return cls(name, grow_per_s=value, fatal=fatal,
                       spec=spec.strip())
        if cmp_op == ">":
            return cls(name, above=value, fatal=fatal,
                       spec=spec.strip())
        return cls(name, below=value, fatal=fatal, spec=spec.strip())

    def evaluate(self, snapshot: dict, now: float) -> Optional[dict]:
        """One snapshot against the rule. Growth rules also fold the
        sample into their series (so call once per snapshot)."""
        val = snapshot.get(self.name)
        if val is None or isinstance(val, bool) \
                or not isinstance(val, (int, float)) \
                or not math.isfinite(val):
            return None
        if self.above is not None:
            if val > self.above:
                return {"rule": self.spec, "gauge": self.name,
                        "value": val, "threshold": self.above}
            return None
        if self.below is not None:
            if val < self.below:
                return {"rule": self.spec, "gauge": self.name,
                        "value": val, "threshold": self.below}
            return None
        self._series.append((float(now), float(val)))
        if len(self._series) < self.MIN_POINTS:
            return None
        slope = _slope(self._series)
        if slope is not None and slope > self.grow_per_s:
            return {"rule": self.spec, "gauge": self.name,
                    "value": val,
                    "slope_per_s": round(slope, 6),
                    "threshold": self.grow_per_s}
        return None


def _slope(series) -> Optional[float]:
    """Least-squares slope of (t, value) pairs; None on a degenerate
    time axis."""
    n = len(series)
    t0 = series[0][0]
    ts = [t - t0 for t, _ in series]
    vs = [v for _, v in series]
    t_mean = sum(ts) / n
    v_mean = sum(vs) / n
    denom = sum((t - t_mean) ** 2 for t in ts)
    if denom <= 0:
        return None
    return sum((t - t_mean) * (v - v_mean)
               for t, v in zip(ts, vs)) / denom


class RunUnhealthyError(RuntimeError):
    """Raised by the watchdog under ``--halt-on-unhealthy`` after the
    corresponding ``obs_alert`` record has been emitted."""


class Watchdog:
    # Steps of step-time history backing the rolling median baseline.
    WINDOW = 64
    # Baseline warmup: no stall verdicts until this many steps seen
    # (the first steps include compile time and are not a baseline).
    MIN_BASELINE = 8
    # Loss-EMA warmup before spike verdicts, and its decay.
    MIN_LOSS_OBS = 5
    LOSS_EMA_DECAY = 0.9
    # Host-thread stall checks piggyback every Nth step (plus the
    # monitor loop and epoch boundaries).
    THREAD_CHECK_STEPS = 16

    def __init__(self, cfg, registry, *, expected_processes: int = 1,
                 clock=time.monotonic):
        self.cfg = cfg
        self.registry = registry
        self.expected_processes = expected_processes
        # Multi-host halt hook: raising RunUnhealthyError on ONE
        # process of a pod would wedge the others in their next
        # collective, so the trainer sets this to the preemption
        # guard's request() — the existing cross-host-agreed stop then
        # halts every process at a step boundary. When unset
        # (single-process), a fatal alert raises directly.
        self.on_fatal = None
        # Proactive checkpoint-and-evict hook (--evict-on-straggler,
        # docs/elasticity.md): the trainer sets this; straggler-shaped
        # alerts (step_stall / thread_stalled) on THIS replica then
        # trigger a checkpoint-now-then-evict through the agreed stop
        # instead of letting the slow host stall the whole pod. Called
        # AFTER the alert record is emitted, subject to the same
        # cooldown as the page itself.
        self.on_evict = None
        self._clock = clock
        self._laps: deque = deque(maxlen=self.WINDOW)
        self._loss_ema: Optional[float] = None
        self._loss_obs = 0
        self._last_beat = clock()
        self._last_progress = clock()
        self._last_step = 0
        self._last_alert_step: dict = {}
        self._monitor: Optional[threading.Thread] = None
        self._stop_monitor = threading.Event()
        self.alerts: list = []
        # Operator-defined GaugePredicate rules (--obs-rule), checked
        # against registry.snapshot() at epoch boundaries.
        self.gauge_predicates: list = []
        for spec in getattr(cfg, "gauge_rules", ()) or ():
            self.gauge_predicates.append(GaugePredicate.parse(spec))

    # -- observations ----------------------------------------------------

    def observe_step(self, step: int, seconds: float) -> None:
        """One finished step's host lap. Checks the stall predicate
        against the pre-existing baseline, then folds the lap in (a
        median baseline is robust to the stalled samples landing in
        the window), then piggybacks the heartbeat-staleness check —
        the step loop is the only reliable periodic pulse we have."""
        cfg = self.cfg
        if (len(self._laps) >= self.MIN_BASELINE
                and cfg.stall_factor > 0):
            baseline = sorted(self._laps)[len(self._laps) // 2]
            threshold = max(baseline * cfg.stall_factor, cfg.stall_min_s)
            if seconds > threshold:
                self._alert("step_stall", step, fatal=True, detail={
                    "step_time_s": round(seconds, 4),
                    "baseline_p50_s": round(baseline, 4),
                    "threshold_s": round(threshold, 4),
                })
        self._laps.append(seconds)
        self._last_progress = self._clock()
        self._last_step = step
        self.check_heartbeat(step=step)
        if step % self.THREAD_CHECK_STEPS == 0:
            # Cheap but not free (a lock + list copy in the registry),
            # so piggyback every Nth step; the monitor thread and the
            # epoch boundary also check, covering wedged-loop cases.
            self.check_threads(step)

    def observe_loss(self, step: int, loss: float) -> None:
        """A host-available loss value (the per-step log line or the
        epoch summary — the watchdog never forces a device sync to get
        one)."""
        if not math.isfinite(loss):
            self._alert("nan_loss", step, fatal=True,
                        detail={"loss": str(loss)})
            return
        spike = self.cfg.loss_spike_factor
        if (spike > 0 and self._loss_ema is not None
                and self._loss_obs >= self.MIN_LOSS_OBS
                and loss > spike * self._loss_ema):
            self._alert("loss_spike", step, fatal=True, detail={
                "loss": round(loss, 6),
                "ema": round(self._loss_ema, 6),
                "factor": spike,
            })
        d = self.LOSS_EMA_DECAY
        self._loss_ema = (loss if self._loss_ema is None
                          else d * self._loss_ema + (1.0 - d) * loss)
        self._loss_obs += 1

    def observe_heartbeat(self, live: int, step: int = 0) -> None:
        """An epoch-boundary heartbeat: ``live`` processes answered
        the allgather."""
        self._last_beat = self._clock()
        if live < self.expected_processes:
            self._alert("missing_processes", step, fatal=True, detail={
                "live": live, "expected": self.expected_processes})

    def check_heartbeat(self, step: int = 0) -> None:
        """Stale-heartbeat predicate: too long since the last epoch
        heartbeat. Off by default (``heartbeat_timeout_s == 0``) —
        epoch length varies by orders of magnitude across configs, so
        the operator sets the budget."""
        timeout = self.cfg.heartbeat_timeout_s
        if timeout <= 0:
            return
        age = self._clock() - self._last_beat
        if age > timeout:
            self._last_beat = self._clock()  # re-arm, don't re-fire per step
            self._alert("stale_heartbeat", step, fatal=False, detail={
                "age_s": round(age, 2), "timeout_s": timeout})

    def check_threads(self, step: int = 0) -> None:
        """``thread_stalled``: a registered host thread
        (tpunet_torch/obs/flightrec/threads.py) past its declared stall
        budget while marked busy. Non-fatal — a stalled writer thread
        is a page, not automatically a dead run — and cooldown-keyed
        per thread, so the orbax writer stalling and the exporter
        stalling in the same window are two distinct pages."""
        from tpunet_torch.obs.flightrec.threads import THREADS
        for handle, age in THREADS.stalled():
            self._alert("thread_stalled", step, fatal=False, detail={
                "thread": handle.name,
                "age_s": round(age, 2),
                "stall_after_s": handle.stall_after_s,
                "state": handle.state,
            }, cooldown_key=f"thread_stalled:{handle.name}")

    def check_gauges(self, step: int, snapshot: dict) -> None:
        """Evaluate every configured ``GaugePredicate`` against a
        registry snapshot (the epoch-boundary hook — the same flat
        gauge view the exporters ship). Fired rules emit a
        ``gauge_predicate`` obs_alert through the normal path
        (cooldown, halt, record-first ordering all apply); the rule
        spec rides in the detail so the page says which rule."""
        now = self._clock()
        for pred in self.gauge_predicates:
            detail = pred.evaluate(snapshot, now)
            if detail is not None:
                # Cooldown per rule, not per reason: two different
                # rules firing in the same window are two pages.
                self._alert("gauge_predicate", step,
                            fatal=pred.fatal, detail=detail,
                            cooldown_key=f"gauge_predicate:{pred.spec}")

    # -- wedge monitor ---------------------------------------------------

    def start_monitor(self) -> None:
        """Background wedge detector (``heartbeat_timeout_s > 0``
        only): the per-step checks above can never fire when the
        training thread is stuck *inside* a step (the canonical dead-
        collective failure) — this daemon thread watches for the
        absence of any progress and emits a ``stale_heartbeat`` alert
        that still reaches the live exporters, so the operator gets
        paged even though the process itself is wedged. Emit-only: it
        never raises or requests a halt (the training thread may be
        beyond saving, and the alert is the point)."""
        if self._monitor is not None or self.cfg.heartbeat_timeout_s <= 0:
            return
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="tpunet-watchdog",
            daemon=True)
        self._monitor.start()

    def stop_monitor(self) -> None:
        if self._monitor is None:
            return
        self._stop_monitor.set()
        self._monitor.join(timeout=2.0)
        self._monitor = None

    def _monitor_loop(self) -> None:
        from tpunet_torch.obs.flightrec import register_thread
        handle = register_thread("watchdog-monitor")
        timeout = self.cfg.heartbeat_timeout_s
        poll = min(max(timeout / 4.0, 0.5), 5.0)
        while not self._stop_monitor.wait(poll):
            handle.beat()
            # Thread stalls are checkable even while the training
            # thread is wedged inside a step — that is this thread's
            # whole reason to exist.
            self.check_threads(self._last_step)
            age = self._clock() - max(self._last_beat,
                                      self._last_progress)
            if age > timeout:
                # The step counter is frozen while wedged, so the
                # per-reason cooldown keyed on it fires exactly once.
                self._alert("stale_heartbeat", self._last_step,
                            fatal=False, detail={
                                "age_s": round(age, 2),
                                "timeout_s": timeout,
                                "source": "monitor"})

    # -- alert emission --------------------------------------------------

    def _alert(self, reason: str, step: int, *, fatal: bool,
               detail: dict, cooldown_key: str = "") -> None:
        # Every detection lands in the flight-recorder ring (raw
        # forensic signal, a ring cannot be flooded); the page feed
        # below still honors the cooldown.
        from tpunet_torch.obs import flightrec
        flightrec.record("alert", f"{reason} step={step}")
        key = cooldown_key or reason
        last = self._last_alert_step.get(key)
        cooldown = self.cfg.alert_cooldown_steps
        if (last is not None and cooldown > 0 and step - last < cooldown):
            # Uniform suppression, fatal included: on the raising path
            # the first alert already ended the run, and on the
            # on_fatal path the stop agreement takes up to
            # STOP_POLL_STEPS steps to land — re-paging every stalled
            # step in between is exactly what the cooldown exists to
            # prevent (guard.request is idempotent, one call suffices).
            self.registry.counter("obs_alerts_suppressed").inc()
            return
        self._last_alert_step[key] = step
        self.registry.counter("obs_alerts").inc()
        record = {"reason": reason, "step": step,
                  "severity": "fatal" if fatal else "warn"}
        record.update(detail)
        self.alerts.append(record)
        self.registry.emit("obs_alert", record)
        if (self.on_evict is not None
                and reason in ("step_stall", "thread_stalled")):
            # Straggler shape on this replica: hand the record to the
            # trainer's evict path (record-first ordering preserved —
            # the page explains the evict that follows).
            self.on_evict(record)
        if self.cfg.halt_on_unhealthy and fatal:
            if self.on_fatal is not None:
                self.on_fatal(record)
                return
            raise RunUnhealthyError(
                f"run unhealthy: {reason} at step {step} ({detail}); "
                "--halt-on-unhealthy is set")
