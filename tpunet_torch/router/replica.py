"""Per-replica handle: state machine + live load probes.

A copy of ``tpunet/router/replica.py`` (stdlib only). It reads the
``serve_*`` keys that both packages' serve engines publish on
``/metrics``, so it probes a port replica and a JAX replica alike.

One ``ReplicaHandle`` per backend replica, whether the router spawned
it (supervisor mode) or was pointed at it (``--replica URL``). The
probe loop drives the state machine; the balancer reads
``routable()`` and ``load_score()``; the frontend counts routed
requests on it.

States::

    STARTING --probe ok--> HEALTHY --drain 503--> DRAINING
        HEALTHY --probe fail x unhealthy_after--> DEAD
        HEALTHY --webhook page / operator--> EVICTED
        DRAINING --Retry-After elapsed + probe ok--> HEALTHY
        DEAD/EVICTED --supervisor respawn--> STARTING

Probes hit ``/healthz`` (liveness, slots, run_id — the join key
webhook pages are matched on) and ``/metrics`` (the
``serve_queue_depth`` / ``serve_active_slots`` gauges plus the
cumulative ``serve_requests_total`` the least-loaded tests assert
on). A replica mid-drain answers 503 with ``Retry-After``; the
handle backs off routing for exactly that long instead of hammering
a shutdown with requests it will reject.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

STARTING = "starting"
HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"
EVICTED = "evicted"

#: States the balancer may route to (STARTING is excluded: the engine
#: may still be compiling; the first successful probe promotes it).
_ROUTABLE = (HEALTHY,)


class ReplicaHandle:
    """Router-side view of one serving replica."""

    def __init__(self, name: str, url: str, *,
                 clock=time.monotonic):
        self.name = name
        self.url = url.rstrip("/")
        self.state = STARTING
        self.run_id = ""
        self._clock = clock
        self._lock = threading.Lock()
        # Latest probe snapshot.
        self.slots = 0
        self.queue_depth = 0
        self.active_slots = 0
        self.serve_requests_total = 0
        self.ttft_p99_s: Optional[float] = None
        self.last_probe_t: Optional[float] = None
        self.fail_streak = 0
        self.backoff_until = 0.0
        # Router-side accounting.
        self.requests_routed = 0
        self.requests_failed = 0

    # -- balancer view ---------------------------------------------------

    def routable(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        return self.state in _ROUTABLE and now >= self.backoff_until

    def load_score(self) -> float:
        """Queued + in-flight work per slot — the least-loaded metric.
        Unknown capacity scores worst so a never-probed replica is
        only picked when nothing better exists."""
        if self.slots <= 0:
            return float("inf")
        return (self.queue_depth + self.active_slots) / self.slots

    def note_routed(self) -> None:
        with self._lock:
            self.requests_routed += 1
            # Optimistic local bump so a burst routed between two
            # probes spreads instead of dogpiling one replica.
            self.active_slots = min(self.active_slots + 1,
                                    max(self.slots, 1))

    def note_failed(self) -> None:
        with self._lock:
            self.requests_failed += 1

    def backoff(self, seconds: float) -> None:
        """Stop routing here for ``seconds`` (drain Retry-After, or a
        429 burst)."""
        with self._lock:
            self.backoff_until = max(self.backoff_until,
                                     self._clock() + seconds)

    # -- probing ---------------------------------------------------------

    def probe(self, timeout: float = 2.0) -> bool:
        """One health+load probe. Returns True when the replica
        answered (healthy OR draining); False on a hard failure
        (connection refused / timeout / 5xx-unhealthy)."""
        try:
            health = self._get_json("/healthz", timeout)
        except _Draining as d:
            with self._lock:
                if self.state in (HEALTHY, STARTING):
                    self.state = DRAINING
                if d.retry_after > 0:
                    self.backoff_until = max(
                        self.backoff_until, self._clock() + d.retry_after)
                self.fail_streak = 0
                self.last_probe_t = self._clock()
                if d.run_id:
                    self.run_id = d.run_id
            return True
        except Exception:  # noqa: BLE001 — any transport failure is
            # the same signal: the replica did not answer.
            with self._lock:
                self.fail_streak += 1
            return False
        with self._lock:
            self.run_id = health.get("run_id") or self.run_id
            self.slots = int(health.get("slots") or self.slots or 0)
            self.queue_depth = int(health.get("queue_depth") or 0)
            self.active_slots = int(health.get("active_slots") or 0)
            self.fail_streak = 0
            self.last_probe_t = self._clock()
            if self.state in (STARTING, DRAINING, DEAD):
                # DEAD recovers on a good probe: an external replica
                # the operator restarted on the same URL rejoins
                # without router surgery (EVICTED does not — a page
                # named it bad; only a respawn resets it).
                self.state = HEALTHY
        # Load gauges + cumulative counters from /metrics — the
        # snapshot is authoritative for occupancy (healthz numbers
        # ride along for capacity); a failed metrics read is not a
        # health failure.
        try:
            snap = self._get_json("/metrics", timeout)
            with self._lock:
                if "serve_queue_depth" in snap:
                    self.queue_depth = int(snap["serve_queue_depth"])
                if "serve_active_slots" in snap:
                    self.active_slots = int(snap["serve_active_slots"])
                self.serve_requests_total = int(
                    snap.get("serve_requests_total", 0))
                if snap.get("serve_ttft_s_p99") is not None:
                    self.ttft_p99_s = float(snap["serve_ttft_s_p99"])
        except Exception:  # noqa: BLE001
            pass
        return True

    def _get_json(self, path: str, timeout: float) -> dict:
        try:
            with urllib.request.urlopen(self.url + path,
                                        timeout=timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            body = {}
            try:
                body = json.loads(e.read())
            except Exception:  # noqa: BLE001
                pass
            if e.code == 503 and body.get("status") == "draining":
                raise _Draining(
                    retry_after=float(e.headers.get("Retry-After") or 0),
                    run_id=body.get("run_id") or "")
            raise

    # -- lifecycle -------------------------------------------------------

    def mark(self, state: str) -> None:
        with self._lock:
            self.state = state

    def reset_for_respawn(self, url: Optional[str] = None) -> None:
        """Back to STARTING with fresh probe state (the supervisor
        respawned the process behind this handle, possibly on a new
        port)."""
        with self._lock:
            if url is not None:
                self.url = url.rstrip("/")
            self.state = STARTING
            self.run_id = ""
            self.fail_streak = 0
            self.backoff_until = 0.0
            self.queue_depth = 0
            self.active_slots = 0
            self.serve_requests_total = 0
            self.ttft_p99_s = None

    def view(self) -> dict:
        """JSON-able row for ``GET /replicas`` and the per-replica
        list on ``obs_router`` records."""
        with self._lock:
            return {
                "name": self.name, "url": self.url,
                "state": self.state, "run_id": self.run_id,
                "slots": self.slots, "queue_depth": self.queue_depth,
                "active_slots": self.active_slots,
                "serve_requests_total": self.serve_requests_total,
                "requests_routed": self.requests_routed,
                "requests_failed": self.requests_failed,
                "fail_streak": self.fail_streak,
            }


class _Draining(Exception):
    """Internal probe signal: the replica answered 503-draining."""

    def __init__(self, retry_after: float = 0.0, run_id: str = ""):
        super().__init__("draining")
        self.retry_after = retry_after
        self.run_id = run_id
