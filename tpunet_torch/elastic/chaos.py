"""Deterministic fault injection for elastic-training tests, a copy of
``tpunet/elastic/chaos.py`` (the port's flight recorder in place of
tpunet's).

A failure story is only as good as its reproductions. This module
turns "a host died mid-epoch" / "the checkpoint write was interrupted"
/ "one replica went slow" from war stories into step-addressed,
seeded, CLI-expressible scenarios: ``--chaos SPEC`` on the train CLI
installs an injector whose hooks the trainer and the checkpointer
call at the exact points real faults strike.

Spec grammar (full reference in docs/elasticity.md)::

    spec    := event (';' event)*
    event   := kind '@' where ('=' N)? (':' key '=' value)*

    kill@step=N[:host=H]            SIGKILL entering global step N
    kill@ckpt=K[:host=H]            SIGKILL during the K-th state save,
                                    after the write is in flight
                                    (a torn, uncommitted checkpoint)
    sigterm@step=N[:host=H][:again=S]
                                    SIGTERM entering step N (the spot
                                    preemption shape); again=S delivers
                                    a SECOND SIGTERM S seconds later
                                    (the escalation path)
    slow@step=N:delay=S[:steps=M][:host=H]
                                    sleep S seconds per step for M
                                    steps (default 1) starting at N —
                                    the straggler shape
    slow@prob=P:delay=S:seed=X[:host=H]
                                    seeded Bernoulli(P) per-step delay
                                    (same seed => same afflicted steps)
    ioerr@save=K[:fails=F][:host=H] the K-th state save's first F
                                    write attempts raise OSError
                                    (default 1) — drives the
                                    checkpointer's retry/backoff
    ioerr@restore=K[:fails=F][:host=H]
                                    likewise for the K-th restore

``host=H`` scopes an event to one process index (default: every
process) — a 2-process gang can lose exactly one host. Events are
one-shot except ``slow``/``ioerr`` whose counts are part of the spec.
Save/restore ordinals are 1-based and count *dispatches*, not retry
attempts, so ``ioerr@save=2:fails=2`` deterministically means "the
second checkpoint's first two attempts fail, the third succeeds".

Everything here is host-side (nothing runs on the device); kills
are real ``SIGKILL``s: no atexit, no flush, no checkpoint
rescue — exactly what the flight recorder's watcher must survive.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpunet_torch.obs import flightrec


class ChaosSpecError(ValueError):
    """A ``--chaos`` spec that does not parse; the message quotes the
    offending event and the grammar form it missed."""


_KINDS = ("kill", "sigterm", "slow", "ioerr")
_WHERES = {
    "kill": ("step", "ckpt"),
    "sigterm": ("step",),
    "slow": ("step", "prob"),
    "ioerr": ("save", "restore"),
}
_FLOAT_KEYS = ("delay", "again", "prob")
_INT_KEYS = ("host", "steps", "fails", "seed", "step", "ckpt", "save",
             "restore", "gen")


@dataclass
class _Event:
    kind: str
    where: str                     # step | ckpt | save | restore | prob
    at: Optional[float]            # step/ordinal number, or probability
    params: Dict[str, float] = field(default_factory=dict)
    fired: int = 0

    def param(self, key: str, default: float = 0.0) -> float:
        return self.params.get(key, default)

    def render(self) -> str:
        kv = "".join(f":{k}={v:g}" for k, v in sorted(self.params.items()))
        at = "" if self.at is None else f"={self.at:g}"
        return f"{self.kind}@{self.where}{at}{kv}"


def _parse_event(text: str) -> _Event:
    def bad(why: str) -> ChaosSpecError:
        return ChaosSpecError(
            f"bad chaos event {text!r}: {why} (grammar: "
            f"kind@where=N[:key=value]*, kinds {'/'.join(_KINDS)} — "
            "see docs/elasticity.md)")

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
    elif where != "restore":
        raise bad(f"@{where} needs a position (e.g. @{where}=3)")
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
    if kind == "slow" and "delay" not in params:
        raise bad("slow needs :delay=SECONDS")
    if where == "prob":
        if at is None or not 0.0 < at <= 1.0:
            raise bad("prob must be in (0, 1]")
        if "seed" not in params:
            raise bad("slow@prob needs :seed=N (seeded => reproducible)")
    return _Event(kind=kind, where=where, at=at, params=params)


class Chaos:
    """The installed injector: parsed events + the hooks the trainer
    and checkpointer call. Injection is synchronous on the calling
    thread except the ``sigterm :again`` escalation timer, which runs
    on a registered background thread (flightrec host-thread
    registry) so the second signal lands while the trainer is busy
    with its grace-window work — the exact race it exists to test."""

    def __init__(self, events: List[_Event], *, process_index: int = 0,
                 generation: int = 0,
                 kill: Callable[[int, int], None] = os.kill,
                 sleep: Callable[[float], None] = time.sleep):
        self.events = events
        self.process_index = process_index
        self.generation = generation
        self._kill = kill
        self._sleep = sleep
        self._rngs: Dict[int, random.Random] = {}

    @classmethod
    def parse(cls, spec: str, *, process_index: int = 0,
              generation: int = 0,
              kill: Callable[[int, int], None] = os.kill,
              sleep: Callable[[float], None] = time.sleep) -> "Chaos":
        events = [_parse_event(part.strip())
                  for part in spec.split(";") if part.strip()]
        if not events:
            raise ChaosSpecError(f"empty chaos spec {spec!r}")
        return cls(events, process_index=process_index,
                   generation=generation, kill=kill, sleep=sleep)

    # -- matching ------------------------------------------------------

    def _mine(self, ev: _Event) -> bool:
        """host=H scopes to one process index; gen=G to one elastic
        generation (so a relaunched incarnation does not replay its
        predecessor's death — the same spec rides the same argv
        across generations)."""
        host = ev.params.get("host")
        if host is not None and int(host) != self.process_index:
            return False
        gen = ev.params.get("gen")
        return gen is None or int(gen) == self.generation

    def _fire_kill(self, ev: _Event, what: str) -> None:
        ev.fired += 1
        # The breadcrumb goes into the crash-durable ring FIRST: the
        # post-mortem report then says the death was injected, not
        # organic.
        flightrec.record("chaos", f"SIGKILL injected ({what})")
        self._kill(os.getpid(), signal.SIGKILL)

    def _fire_sigterm(self, ev: _Event, step: int) -> None:
        ev.fired += 1
        flightrec.record("chaos", f"SIGTERM injected step={step}")
        self._kill(os.getpid(), signal.SIGTERM)
        again = ev.param("again")
        if again > 0:
            handle = flightrec.register_thread("chaos-sigterm")

            def escalate() -> None:
                handle.beat("busy")
                self._sleep(again)
                flightrec.record("chaos", "second SIGTERM injected")
                self._kill(os.getpid(), signal.SIGTERM)
                handle.beat("idle")

            threading.Thread(target=escalate, name="chaos-sigterm",
                             daemon=True).start()

    # -- hooks ---------------------------------------------------------

    def step(self, global_step: int) -> None:
        """Called at the top of every train step (host-side)."""
        for i, ev in enumerate(self.events):
            if not self._mine(ev):
                continue
            if ev.kind == "slow" and ev.where == "prob":
                rng = self._rngs.setdefault(
                    i, random.Random(int(ev.param("seed"))))
                # One draw per step keeps the sequence step-addressed:
                # the same seed afflicts the same steps in every run.
                if rng.random() < float(ev.at or 0.0):
                    ev.fired += 1
                    flightrec.record(
                        "chaos", f"slow step={global_step}")
                    self._sleep(ev.param("delay"))
                continue
            if ev.at is None or int(ev.at) > global_step:
                continue
            if ev.kind == "slow" and ev.where == "step":
                span = int(ev.param("steps", 1.0))
                if global_step < int(ev.at) + span:
                    ev.fired += 1
                    flightrec.record(
                        "chaos", f"slow step={global_step}")
                    self._sleep(ev.param("delay"))
                continue
            if int(ev.at) != global_step or ev.fired:
                continue
            if ev.kind == "kill" and ev.where == "step":
                self._fire_kill(ev, f"step={global_step}")
            elif ev.kind == "sigterm":
                self._fire_sigterm(ev, global_step)

    def save_attempt(self, save_index: int, attempt: int) -> None:
        """Called before each state-save write attempt (``save_index``
        is the 1-based dispatch ordinal, ``attempt`` the 0-based retry
        count). Raises the injected transient ``OSError``."""
        self._io_attempt("save", save_index, attempt)

    def restore_attempt(self, restore_index: int, attempt: int) -> None:
        self._io_attempt("restore", restore_index, attempt)

    def _io_attempt(self, where: str, index: int, attempt: int) -> None:
        for ev in self.events:
            if ev.kind != "ioerr" or ev.where != where \
                    or not self._mine(ev):
                continue
            if ev.at is not None and int(ev.at) != index:
                continue
            if attempt < int(ev.param("fails", 1.0)):
                ev.fired += 1
                flightrec.record(
                    "chaos", f"ioerr {where} index={index} "
                             f"attempt={attempt}")
                raise OSError(
                    f"chaos: injected transient {where} IO error "
                    f"(index={index}, attempt={attempt})")

    def save_in_flight(self, save_index: int) -> None:
        """Called once per state save after the write to the temporary
        file and before its rename into place (the commit) — the
        mid-checkpoint-write kill point (the checkpoint on disk is
        torn: written but never finalized)."""
        for ev in self.events:
            if ev.kind == "kill" and ev.where == "ckpt" \
                    and self._mine(ev) and not ev.fired \
                    and ev.at is not None and int(ev.at) == save_index:
                self._fire_kill(ev, f"ckpt={save_index}")

    def render(self) -> str:
        return ";".join(ev.render() for ev in self.events)


# -- process-global install (the checkpointer reaches the injector
# -- without threading it through every constructor) -------------------

_CURRENT: Optional[Chaos] = None


def install(spec: str, *, process_index: int = 0) -> Chaos:
    """Parse and arm the process-global injector (``--chaos``). The
    elastic generation is read from the agent-exported env var, so
    ``gen=G`` events address one incarnation of the run."""
    global _CURRENT
    try:
        generation = int(os.environ.get("TPUNET_ELASTIC_GENERATION",
                                        "0"))
    except ValueError:
        generation = 0
    _CURRENT = Chaos.parse(spec, process_index=process_index,
                           generation=generation)
    flightrec.record("chaos", f"armed {_CURRENT.render()} "
                              f"host={process_index} "
                              f"gen={generation}")
    return _CURRENT


def current() -> Optional[Chaos]:
    return _CURRENT


def clear() -> None:
    global _CURRENT
    _CURRENT = None
