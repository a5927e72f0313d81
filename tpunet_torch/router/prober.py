"""Synthetic canary prober: known-answer requests through the fleet.

A copy of ``tpunet/router/prober.py`` (stdlib only; its flight
recorder and tracing are the port's copies).

Passive metrics only see the traffic that arrives and only the
dimensions the servers measure about themselves. The prober is the
client's advocate inside the router process: on a fixed cadence
(``--probe-every-s``) it issues a pinned greedy request through the
ROUTER'S OWN public endpoint — the full proxy path: routing,
affinity, retries, journaling, mid-stream failover — and judges the
answer like a client would:

- **availability**: did a well-formed stream come back in time;
- **latency**: TTFT (first token line) and e2e, measured from the
  client side of the socket;
- **correctness**: are the tokens BITWISE identical to the golden
  sequence — the SLI no passive metric can see (a bad weight rollout
  serves fast, available, *wrong* tokens). The golden is the first
  clean probe's output: generation is greedy and deterministic, so
  every replica — and a mid-probe failover resume — must reproduce
  it exactly.

Every probe mints an ``X-Trace-Id`` (always adopted + sampled by the
frontend), so a failed or slow probe points at a replayable trace —
the id travels into the SLO engine and onto the page that follows.
Probe verdicts feed the same SLI streams as real traffic
(tpunet_torch/obs/slo.py); the ``probe`` body marker keeps the frontend
from double-counting them in the passive feed.

The probe prompt rotates a ``session`` key so session affinity
spreads probes across the fleet instead of pinning them to one
replica's rendezvous slot; the token prompt itself never varies (the
golden depends on it).

The prober ARMS on its first clean probe (the one that sets the
golden): failures before that — the router booted faster than its
replicas, which is every cold start — count in
``prober_failures_total`` but do not feed the SLO engine. Boot
gating belongs to readiness checks; an error budget measures what
clients saw from a fleet that had come up.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import List, Optional

from tpunet_torch.obs import flightrec, tracing

#: Pinned probe prompt: token ids kept tiny so the smallest test
#: vocabularies (31) accept them. Changing this invalidates goldens.
PROBE_PROMPT = (1, 2, 3, 5, 7, 11, 13, 2)

#: Tokens the probe asks for: long enough to cross a failover seam,
#: short enough to stay far under the overhead gate.
PROBE_NEW_TOKENS = 8

#: Distinct session keys probes rotate through (spreads probes over
#: the fleet's rendezvous slots).
PROBE_SESSIONS = 8


class Prober:
    """The prober thread. ``start()`` after the frontend listens
    (it needs the bound port); ``stop()`` before teardown."""

    def __init__(self, cfg, engine, *, registry,
                 base_url: str, clock=time.perf_counter):
        self.cfg = cfg
        self.engine = engine           # SloEngine (note_probe sink)
        self.registry = registry
        self.base_url = base_url.rstrip("/")
        self._clock = clock
        # Per-socket-op AND whole-probe budget: a stalled stream whose
        # individual lines stay under the socket timeout is still
        # failed when the probe as a whole runs past it.
        self.timeout_s = max(cfg.probe_timeout_s,
                             2.0 * cfg.probe_every_s)
        self.golden: Optional[List[int]] = None
        self.last_trace_id = ""
        self._n = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Prober":
        handle = flightrec.register_thread("router-prober",
                                           stall_after_s=120.0)
        flightrec.record("router",
                         f"prober start every={self.cfg.probe_every_s}s"
                         f" timeout={self.timeout_s:.2f}s")

        def run() -> None:
            while not self._stop.is_set():
                handle.beat("busy")
                try:
                    self.probe_once()
                except Exception as e:  # noqa: BLE001 — a prober crash
                    # must never take the router down; the failed
                    # probe is itself the signal.
                    flightrec.record("router", f"prober error: {e}")
                    if self.golden is not None:   # armed (see module
                        self.engine.note_probe(   # docstring)
                            ok=False, trace_id=self.last_trace_id)
                handle.beat("idle")
                self._stop.wait(self.cfg.probe_every_s)

        self._thread = threading.Thread(
            target=run, daemon=True, name="tpunet-router-prober")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + 1.0)

    # -- one probe -------------------------------------------------------

    def _body(self) -> dict:
        self._n += 1
        return {"tokens": list(PROBE_PROMPT),
                "max_new_tokens": PROBE_NEW_TOKENS,
                "stream": True,
                # Greedy + pinned seed: bitwise-reproducible across
                # replicas and across a mid-probe failover resume.
                "temperature": 0.0, "seed": 7,
                "session": f"slo-probe-{self._n % PROBE_SESSIONS}",
                "probe": True}

    def probe_once(self) -> bool:
        """Issue one probe and feed the verdict to the registry and
        the SLO engine. Returns the availability verdict."""
        trace_id = tracing.mint_trace_id()
        self.last_trace_id = trace_id
        self.registry.counter("prober_requests_total").inc()
        t0 = self._clock()
        deadline = t0 + self.timeout_s
        ok = False
        mismatch = False
        ttft_s: Optional[float] = None
        tokens: List[int] = []
        req = urllib.request.Request(
            self.base_url + "/v1/generate",
            json.dumps(self._body()).encode(),
            {"Content-Type": "application/json",
             tracing.TRACE_HEADER: trace_id})
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_s)
            try:
                for line in resp:
                    now = self._clock()
                    if now > deadline:
                        break                    # wedged mid-stream
                    ev = json.loads(line)
                    if "token" in ev:
                        if ttft_s is None:
                            ttft_s = now - t0
                        tokens.append(int(ev["token"]))
                        continue
                    if ev.get("done"):
                        ok = not ev.get("error") \
                            and ev.get("finish_reason") \
                            not in ("error", "deadline")
                        break
            finally:
                resp.close()
        except Exception:  # noqa: BLE001 — timeout, refused, torn
            ok = False     # stream: all the same availability verdict
        e2e_s = self._clock() - t0
        if ok and not tokens:
            ok = False                 # a done frame with no tokens
        if ok:
            if self.golden is None:
                self.golden = list(tokens)
                flightrec.record(
                    "router", f"prober golden set n={len(tokens)}")
            elif tokens != self.golden:
                mismatch = True
                self.registry.counter("prober_mismatch_total").inc()
                flightrec.record(
                    "router",
                    f"prober GOLDEN MISMATCH trace={trace_id}")
            self.registry.histogram("prober_e2e_s").observe(e2e_s)
            if ttft_s is not None:
                self.registry.histogram("prober_ttft_s").observe(
                    ttft_s)
        else:
            self.registry.counter("prober_failures_total").inc()
        if ok or self.golden is not None:   # warmup gate: unarmed
            self.engine.note_probe(         # failures don't burn
                ok=ok, mismatch=mismatch, ttft_s=ttft_s,
                e2e_s=e2e_s if ok else None, trace_id=trace_id)
        return ok
