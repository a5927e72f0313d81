"""Deterministic fault injection for the SERVING tier, a copy of
``tpunet/serve/chaos.py``.

The tier that faces live clients: ``--chaos
SPEC`` on the serve CLI (or on the router CLI, scoped per replica
index and forwarded to spawned children) installs an injector whose
hooks the engine and the HTTP frontend call at the exact points real
faults strike: token production, prefill dispatch, health probes, and
the streaming relay.

Spec grammar (full reference in docs/serving.md "Mid-stream failover
& serve-tier chaos")::

    spec    := event (';' event)*
    event   := kind '@' where ('=' N)? (':' key '=' value)*

    kill@tokens=N                SIGKILL after this replica has
                                 generated its N-th token (counted
                                 across requests since boot) — the
                                 token reaches the stream first, so
                                 the seam where a replica "emitted
                                 token N as it died" is exercised
    kill@prefill[=K]             SIGKILL during the K-th prefill
                                 device call (default 1), before any
                                 response byte — the re-route-before-
                                 first-byte path
    stall@tokens=N:ms=M          once N tokens are generated, the
                                 engine loop AND every /healthz
                                 answer sleep M ms — the wedged
                                 replica the router must stall-evict
    drop-probe@prob=P:seed=X     seeded Bernoulli(P): matching
                                 /healthz probes answer 500 — flaky-
                                 probe resilience (same seed => same
                                 afflicted probes)
    slow-stream@ms=M             every streamed ndjson line is
                                 delayed M ms — slow-consumer /
                                 slow-producer relay behavior

On the ROUTER CLI every event additionally takes ``:replica=I`` to
scope it to spawned child ``I`` (``split_by_replica``); unscoped
events reach every child. Events are one-shot for ``kill``, standing
for the rest. Kills are real ``SIGKILL``s — no flush, no drain,
exactly what the failover journal must survive. Before one fires, the
port's HTTP frontend (``ServeChaos.before_kill``) waits for its stream
relays to write the tokens already pushed, so a streamed request of
``kill@tokens=N`` receives exactly N tokens.

Everything here is host-side: the hooks run on the engine thread and
the HTTP handler threads, never inside a device call.
"""

from __future__ import annotations

import os
import random
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpunet_torch.obs import flightrec


class ServeChaosError(ValueError):
    """A ``--chaos`` spec that does not parse; the message quotes the
    offending event and the grammar form it missed."""


_KINDS = ("kill", "stall", "drop-probe", "slow-stream")
_WHERES = {
    "kill": ("tokens", "prefill"),
    "stall": ("tokens",),
    "drop-probe": ("prob",),
    "slow-stream": ("ms",),
}
_FLOAT_KEYS = ("ms", "prob")
_INT_KEYS = ("seed", "replica", "tokens", "prefill")


@dataclass
class _Event:
    kind: str
    where: str                 # tokens | prefill | prob | ms
    at: Optional[float]        # count / ordinal / probability / ms
    params: Dict[str, float] = field(default_factory=dict)
    fired: int = 0

    def param(self, key: str, default: float = 0.0) -> float:
        return self.params.get(key, default)

    def render(self) -> str:
        kv = "".join(f":{k}={v:g}"
                     for k, v in sorted(self.params.items()))
        at = "" if self.at is None else f"={self.at:g}"
        return f"{self.kind}@{self.where}{at}{kv}"


def _parse_event(text: str) -> _Event:
    def bad(why: str) -> ServeChaosError:
        return ServeChaosError(
            f"bad serve chaos event {text!r}: {why} (grammar: "
            f"kind@where=N[:key=value]*, kinds {'/'.join(_KINDS)} — "
            "see docs/serving.md)")

    head, _, tail = text.partition(":")
    if "@" not in head:
        raise bad("missing '@'")
    kind, _, where_part = head.partition("@")
    kind = kind.strip()
    if kind not in _KINDS:
        raise bad(f"unknown kind {kind!r}")
    where, _, at_text = where_part.partition("=")
    where = where.strip()
    if where not in _WHERES[kind]:
        raise bad(f"kind {kind!r} takes @{'/@'.join(_WHERES[kind])}, "
                  f"not @{where!r}")
    at: Optional[float] = None
    if at_text:
        try:
            at = float(at_text)
        except ValueError:
            raise bad(f"non-numeric position {at_text!r}") from None
    elif where != "prefill":
        raise bad(f"@{where} needs a value (e.g. @{where}=3)")
    params: Dict[str, float] = {}
    if tail:
        for pair in tail.split(":"):
            key, eq, val = pair.partition("=")
            key = key.strip()
            if not eq or key not in _FLOAT_KEYS + _INT_KEYS:
                raise bad(f"unknown or malformed key {pair!r}")
            try:
                params[key] = float(val)
            except ValueError:
                raise bad(f"non-numeric value in {pair!r}") from None
    if kind == "stall" and "ms" not in params:
        raise bad("stall needs :ms=MILLIS")
    if where == "prob":
        if at is None or not 0.0 < at <= 1.0:
            raise bad("prob must be in (0, 1]")
        if "seed" not in params:
            raise bad("drop-probe needs :seed=N (seeded => "
                      "reproducible)")
    return _Event(kind=kind, where=where, at=at, params=params)


def split_by_replica(spec: str) -> Dict[Optional[int], str]:
    """Split a router-level spec into per-child specs by the
    ``replica=I`` scope key: ``{0: "kill@tokens=5", None: "..."}``.
    ``None`` carries the unscoped events (they reach every child);
    the scope key itself is stripped from the forwarded event. The
    whole spec is parse-validated first so a typo fails the router
    boot, not a child boot minutes later."""
    out: Dict[Optional[int], List[str]] = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        ev = _parse_event(part)          # raises ServeChaosError
        replica = ev.params.pop("replica", None)
        idx = None if replica is None else int(replica)
        out.setdefault(idx, []).append(ev.render())
    return {idx: ";".join(parts) for idx, parts in out.items()}


def spec_for_replica(spec: str, index: int) -> str:
    """The ``--chaos`` spec child ``index`` should be launched with
    (scoped events for this index + every unscoped event), or ""
    when nothing addresses it."""
    if not spec:
        return ""
    by_idx = split_by_replica(spec)
    parts = [s for key, s in by_idx.items()
             if key is None or key == index]
    return ";".join(parts)


class ServeChaos:
    """The installed injector: parsed events + the hooks the engine
    and HTTP frontend call. ``kill`` injection is synchronous on the
    calling thread (the engine loop / prefill path); ``stall`` flips
    a standing flag that both the engine loop and the health endpoint
    observe — a wedged replica is wedged everywhere the router can
    see it."""

    def __init__(self, events: List[_Event], *,
                 kill: Callable[[int, int], None] = os.kill,
                 sleep: Callable[[float], None] = time.sleep):
        self.events = events
        self._kill = kill
        self._sleep = sleep
        self._tokens = 0
        self._prefills = 0
        self._probes = 0
        self._rngs: Dict[int, random.Random] = {}
        self.stalled = False
        self.stall_ms = 0.0
        # Called just before a kill: the HTTP frontend sets it to wait
        # for its stream relays, so the token that fires kill@tokens
        # reaches its client before the process dies.
        self.before_kill: Callable[[], None] = lambda: None

    @classmethod
    def parse(cls, spec: str, *,
              kill: Callable[[int, int], None] = os.kill,
              sleep: Callable[[float], None] = time.sleep
              ) -> "ServeChaos":
        events = [_parse_event(part.strip())
                  for part in spec.split(";") if part.strip()]
        if not events:
            raise ServeChaosError(f"empty chaos spec {spec!r}")
        return cls(events, kill=kill, sleep=sleep)

    def _fire_kill(self, ev: _Event, what: str) -> None:
        ev.fired += 1
        # The breadcrumb goes into the crash-durable ring FIRST: the
        # post-mortem report then says the death was injected, not
        # organic.
        flightrec.record("chaos", f"SIGKILL injected ({what})")
        self.before_kill()
        self._kill(os.getpid(), signal.SIGKILL)

    # -- engine hooks --------------------------------------------------

    def on_token(self) -> None:
        """Called by the engine after each generated token is pushed
        (the token reaches the stream BEFORE the kill — the seam a
        failover journal must survive)."""
        self._tokens += 1
        for ev in self.events:
            if ev.where != "tokens" or ev.at is None \
                    or self._tokens < int(ev.at):
                continue
            if ev.kind == "kill" and not ev.fired:
                self._fire_kill(ev, f"tokens={self._tokens}")
            elif ev.kind == "stall" and not self.stalled:
                self.stalled = True
                self.stall_ms = ev.param("ms")
                flightrec.record(
                    "chaos", f"stall armed tokens={self._tokens} "
                             f"ms={self.stall_ms:g}")

    def on_prefill(self) -> None:
        """Called by the engine before each prefill device call."""
        self._prefills += 1
        for ev in self.events:
            if ev.kind != "kill" or ev.where != "prefill" or ev.fired:
                continue
            ordinal = 1 if ev.at is None else int(ev.at)
            if self._prefills >= ordinal:
                self._fire_kill(ev, f"prefill={self._prefills}")

    def maybe_stall(self) -> None:
        """Engine-loop stall point: once armed, every iteration sleeps
        the configured budget (the decode stream wedges)."""
        if self.stalled:
            self._sleep(self.stall_ms / 1e3)

    # -- frontend hooks ------------------------------------------------

    def on_probe(self) -> bool:
        """Called per /healthz request. True = drop this probe (the
        handler answers 500). A standing stall also wedges the probe
        itself (sleep past the router's probe timeout) so the wedged
        replica fails its health checks the way a wedged process
        does."""
        if self.stalled:
            self._sleep(self.stall_ms / 1e3)
        self._probes += 1
        for i, ev in enumerate(self.events):
            if ev.kind != "drop-probe":
                continue
            rng = self._rngs.setdefault(
                i, random.Random(int(ev.param("seed"))))
            # One draw per probe keeps the sequence probe-addressed:
            # the same seed drops the same probes in every run.
            if rng.random() < float(ev.at or 0.0):
                ev.fired += 1
                flightrec.record("chaos",
                                 f"probe dropped n={self._probes}")
                return True
        return False

    def on_stream_line(self) -> None:
        """Called by the streaming frontend before each relayed ndjson
        line (slow-stream)."""
        for ev in self.events:
            if ev.kind == "slow-stream" and ev.at:
                ev.fired += 1
                self._sleep(float(ev.at) / 1e3)

    def render(self) -> str:
        return ";".join(ev.render() for ev in self.events)


def install(spec: str) -> Optional[ServeChaos]:
    """Parse and arm an injector for this serve process (``--chaos``),
    or None for an empty spec."""
    if not spec:
        return None
    chaos = ServeChaos.parse(spec)
    flightrec.record("chaos", f"armed {chaos.render()}")
    return chaos
