"""Hysteresis autoscale policy over fleet queue depth and TTFT SLO.

A copy of ``tpunet/router/policy.py`` (stdlib only): the same
decisions over the same probe series.

The scale signal is deliberately boring: *sustained* fleet queue
depth per slot (the backpressure number the serve docs already teach
operators to watch) plus, when a TTFT SLO is configured, the SLO
burn ratio (fleet TTFT p99 / SLO). Hysteresis comes from three
guards — a condition must hold for ``scale_window_probes``
consecutive probe rounds to fire, up- and down-thresholds are far
apart, and every action starts a ``scale_cooldown_s`` hold — so a
bursty queue cannot flap the fleet, and a scale-up (a replica boot:
never free) only happens under pressure that is real.
"""

from __future__ import annotations

import time
from typing import Optional

SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"


class AutoscalePolicy:
    """Pure decision logic — no spawning, no probing; the Router's
    control loop feeds it one observation per probe round and acts on
    the decision it returns."""

    def __init__(self, cfg, *, clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._up_rounds = 0
        self._down_rounds = 0
        self._hold_until = 0.0
        self.last_decision = "hold"

    def slo_burn(self, ttft_p99_s: Optional[float]) -> Optional[float]:
        """TTFT SLO burn ratio (>1 = burning), or None when no SLO is
        configured or no sample exists."""
        if self.cfg.ttft_slo_ms <= 0 or ttft_p99_s is None:
            return None
        return ttft_p99_s / (self.cfg.ttft_slo_ms / 1e3)

    def observe(self, *, queue_depth: int, slots: int,
                ttft_p99_s: Optional[float],
                replicas: int) -> Optional[str]:
        """One probe-round observation -> SCALE_UP / SCALE_DOWN /
        None. ``replicas`` counts live (non-dead) replicas; min/max
        bounds and the cooldown are enforced here so the caller can
        act on any non-None return unconditionally."""
        now = self._clock()
        if slots <= 0:
            # No healthy capacity to measure (fleet still booting, or
            # everything dead): an empty queue here is ignorance, not
            # idleness — don't let boot time arm a scale-down.
            self._up_rounds = 0
            self._down_rounds = 0
            return None
        per_slot = queue_depth / slots
        burn = self.slo_burn(ttft_p99_s)
        pressure = per_slot >= self.cfg.scale_up_queue_per_slot \
            or (burn is not None and burn > 1.0)
        idle = per_slot <= self.cfg.scale_down_queue_per_slot \
            and (burn is None or burn < 1.0)
        self._up_rounds = self._up_rounds + 1 if pressure else 0
        self._down_rounds = self._down_rounds + 1 if idle else 0
        if now < self._hold_until:
            return None
        if self._up_rounds >= self.cfg.scale_window_probes \
                and replicas < self.cfg.max_replicas:
            self._fire(now)
            self.last_decision = SCALE_UP
            return SCALE_UP
        if self._down_rounds >= self.cfg.scale_window_probes \
                and replicas > self.cfg.min_replicas:
            self._fire(now)
            self.last_decision = SCALE_DOWN
            return SCALE_DOWN
        return None

    def _fire(self, now: float) -> None:
        self._up_rounds = 0
        self._down_rounds = 0
        self._hold_until = now + self.cfg.scale_cooldown_s
