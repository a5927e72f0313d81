"""Filesystem rendezvous for elastic host membership, a copy of
``tpunet/elastic/rendezvous.py`` (stdlib only).

Surviving hosts of a shrinking (or growing) pod need to agree on the
next generation's membership without any surviving coordinator — the
coordinator may be the host that died. The agreement medium here is a
shared directory (tests: a tmpdir; a real pod: NFS/GCS-fuse — the
same place the checkpoints already live), because it is the one
dependency the checkpoint path already requires and it survives any
subset of hosts dying.

Protocol (docs/elasticity.md "Rendezvous protocol"):

- membership is **generation-numbered**: generation ``G``'s
  announcements live under ``gen-<G>/<host>.json``, each stamped with
  the host's latest known checkpoint ``epoch``/``step``, its pid, a
  coordinator-candidate ``addr:port``, and a wall-clock time;
- ``gather(G)`` waits until the announced set has been **stable for
  ``settle_s``** (no arrivals), then returns it sorted by host id —
  rank and coordinator assignment are therefore deterministic across
  hosts with no messages exchanged;
- the gather is **timeout-bounded**: past ``timeout_s``, fewer than
  ``min_hosts`` announcements is a ``QuorumError`` (the clean
  "cannot form quorum" degradation — the agent reports it and exits
  nonzero instead of spinning);
- departure is a ``gone/<host>`` marker (evicted or restart-budget-
  exhausted hosts write it; gone hosts are excluded from every later
  generation) — a host that dies *without* marking (SIGKILL takes the
  agent too) is detected by its **heartbeat file** going stale
  (``hb/<host>``, touched by the agent's supervise loop);
- a new host joins by writing ``join/<host>`` (grow): running agents
  poll ``join_requests()`` and trigger the next generation, where the
  joiner announces like everyone else.

Everything is write-once-per-path or atomic-rename, so torn reads are
impossible and retries are idempotent.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


class QuorumError(RuntimeError):
    """Rendezvous timed out below ``min_hosts`` — the pod cannot form
    a quorum and the caller must degrade cleanly, not spin."""


class Rendezvous:
    POLL_S = 0.05

    def __init__(self, directory: str, host_id: str, *,
                 min_hosts: int = 1, settle_s: float = 1.0,
                 timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if not host_id or "/" in host_id:
            raise ValueError(f"bad host id {host_id!r}")
        if min_hosts < 1:
            raise ValueError(f"min_hosts must be >= 1, got {min_hosts}")
        self.directory = os.path.abspath(directory)
        self.host_id = host_id
        self.min_hosts = min_hosts
        self.settle_s = settle_s
        self.timeout_s = timeout_s
        self._clock = clock
        self._sleep = sleep
        for sub in ("gone", "hb", "join"):
            os.makedirs(os.path.join(self.directory, sub), exist_ok=True)

    # -- paths ---------------------------------------------------------

    def _gen_dir(self, generation: int) -> str:
        return os.path.join(self.directory, f"gen-{generation:06d}")

    def _write_json(self, path: str, payload: dict) -> None:
        tmp = f"{path}.tmp.{self.host_id}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    # -- announcements -------------------------------------------------

    def announce(self, generation: int, info: Optional[dict] = None
                 ) -> None:
        """Publish this host's membership in ``generation`` (idempotent
        — re-announcing overwrites with fresher stamps)."""
        gen_dir = self._gen_dir(generation)
        os.makedirs(gen_dir, exist_ok=True)
        payload = {"host": self.host_id, "pid": os.getpid(),
                   "time": time.time()}
        payload.update(info or {})
        self._write_json(os.path.join(gen_dir, f"{self.host_id}.json"),
                         payload)

    def members(self, generation: int) -> Dict[str, dict]:
        """Announced (and not departed) hosts of ``generation``."""
        gen_dir = self._gen_dir(generation)
        out: Dict[str, dict] = {}
        gone = self.gone()
        try:
            names = os.listdir(gen_dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            host = name[:-len(".json")]
            if host in gone:
                continue
            try:
                with open(os.path.join(gen_dir, name)) as f:
                    out[host] = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # torn concurrent write: next poll sees it
        return out

    def latest_generation(self) -> int:
        """Highest generation any host has announced into (-1: none).
        The trigger signal: an agent seeing a generation beyond its
        own knows a peer has declared a membership change."""
        latest = -1
        try:
            names = os.listdir(self.directory)
        except OSError:
            return latest
        for name in names:
            if name.startswith("gen-"):
                try:
                    latest = max(latest, int(name[4:]))
                except ValueError:
                    continue
        return latest

    # -- gather --------------------------------------------------------

    def gather(self, generation: int) -> List[Tuple[str, dict]]:
        """Wait for generation ``G``'s membership to stabilize and
        return it sorted by host id (rank order). Raises
        ``QuorumError`` on timeout below ``min_hosts``."""
        deadline = self._clock() + self.timeout_s
        seen: Set[str] = set()
        stable_since = self._clock()
        while True:
            members = self.members(generation)
            hosts = set(members)
            now = self._clock()
            if hosts != seen:
                seen = hosts
                stable_since = now
            if (self.host_id in hosts
                    and len(hosts) >= self.min_hosts
                    and now - stable_since >= self.settle_s):
                return sorted(members.items())
            if now >= deadline:
                if self.host_id in hosts and len(hosts) >= self.min_hosts:
                    return sorted(members.items())
                raise QuorumError(
                    f"rendezvous generation {generation}: "
                    f"{len(hosts)} host(s) announced "
                    f"({sorted(hosts)}) after {self.timeout_s:.1f}s, "
                    f"need >= {self.min_hosts} — cannot form quorum")
            self._sleep(self.POLL_S)

    # -- departure / liveness ------------------------------------------

    def mark_gone(self, host: Optional[str] = None) -> None:
        """Record a departed host (self by default): excluded from
        every current and future generation's membership."""
        path = os.path.join(self.directory, "gone", host or self.host_id)
        with open(path, "w") as f:
            f.write(f"{time.time()}\n")

    def gone(self) -> Set[str]:
        try:
            return set(os.listdir(os.path.join(self.directory, "gone")))
        except OSError:
            return set()

    def heartbeat(self) -> None:
        """Touch this host's liveness file (agent supervise loop)."""
        path = os.path.join(self.directory, "hb", self.host_id)
        with open(path, "w") as f:
            f.write(f"{time.time()}\n")
        # mtime is the signal; the wall-clock content is for humans.

    def stale_peers(self, peers: List[str], dead_after_s: float
                    ) -> Set[str]:
        """Peers (excluding self) whose heartbeat file is absent or
        older than ``dead_after_s`` — the SIGKILLed-agent detection
        path (a gracefully leaving host marks ``gone`` instead and is
        detected faster)."""
        stale: Set[str] = set()
        now = time.time()
        for host in peers:
            if host == self.host_id:
                continue
            path = os.path.join(self.directory, "hb", host)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                stale.add(host)
                continue
            if age > dead_after_s:
                stale.add(host)
        return stale

    # -- grow ----------------------------------------------------------

    def request_join(self) -> None:
        """A new host asks the running pod to re-rendezvous (grow)."""
        path = os.path.join(self.directory, "join", self.host_id)
        with open(path, "w") as f:
            f.write(f"{time.time()}\n")

    def join_requests(self) -> Set[str]:
        try:
            joins = set(os.listdir(os.path.join(self.directory, "join")))
        except OSError:
            return set()
        return joins - self.gone()

    def clear_join(self, host: str) -> None:
        try:
            os.unlink(os.path.join(self.directory, "join", host))
        except OSError:
            pass
