"""The per-host elastic agent: supervise, rendezvous, relaunch; the
port of ``tpunet/elastic/agent.py``.

One agent runs on every host of an elastic pod (``python -m
tpunet_torch.elastic``). It imports no torch and nothing of the port
outside this package — it is a pure-stdlib supervisor, so it survives
everything the trainer can die of — and it closes the loop:

    launch trainer child against generation G's membership
      └─ child dies (SIGKILL / crash)      ──┐
      └─ a peer's agent marks gone / goes   ├─> stop wedged child,
         silent / announces G+1             │   re-rendezvous G+1,
      └─ child stops for preemption/evict ──┘   relaunch with --resume

The re-mesh needs no mesh surgery: generation G+1's child joins a new
process group of the surviving hosts (the launcher's variables
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, the address being generation G+1's first member's),
the mesh's ``data`` axis follows the world (``MeshConfig.data = -1``),
and the trainer's ``--resume`` restores the last intact ``state.pt``,
which holds the whole state, onto the new mesh. A world of one boots
without the launcher's variables, so its child makes no group of dead
peers. ``AgentConfig.env`` adds or removes more of the child's
variables (``CUDA_VISIBLE_DEVICES`` pins a host's card).

Child-exit classification (markers from ``tpunet_torch/elastic/events.py``):

- ``elastic/done``       -> every epoch finished: agent exits 0;
- ``elastic/evict.json`` -> agreed evict: the named host leaves
  (marks ``gone``, exits 0), survivors re-rendezvous. The named host
  also reads the marker when a peer announces the next generation
  before its own child has exited, and the next generation's rank 0
  clears it only once that host is gone (tpunet's agent reads it after
  the exit alone, so a slow-stopping evicted host could rejoin);
- exit 0, no marker      -> clean preemption stop: restart;
- nonzero / signal       -> failure: restart while the per-host
  ``max_restarts`` budget lasts, else the host marks ``gone`` and
  exits 2 (host death from the pod's point of view).

Membership changes are appended to the run's ``metrics.jsonl`` as
``obs_elastic`` records by generation G+1's rank-0 agent (shrink /
grow / restart, with ``recovery_s`` = detection -> relaunch), under
the run's original ``run_id``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpunet_torch.elastic import events
from tpunet_torch.elastic.rendezvous import QuorumError, Rendezvous

# Exit codes (docs/elasticity.md "Agent exit codes").
EXIT_DONE = 0          # training completed (or this host was evicted)
EXIT_RESTARTS = 2      # per-host restart budget exhausted
EXIT_QUORUM = 3        # rendezvous could not form a quorum
EXIT_GENERATIONS = 4   # generation budget exhausted (runaway guard)

# The launcher's variables (``tpunet_torch.parallel.dist``), which name
# the child's process group.
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
# The committed-save sidecar, ``tpunet_torch.ckpt.STATE_META``: renamed
# into place after ``state.pt``, so a torn write never shows here.
STATE_META = "state_meta.json"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class AgentConfig:
    run_dir: str               # shared checkpoint/metrics directory
    rdzv_dir: str              # shared rendezvous directory
    host_id: str
    command: List[str]         # child argv (without --resume)
    addr: str = "127.0.0.1"    # this host's address for the coordinator
    min_hosts: int = 1
    max_restarts: int = 1      # child failures this host absorbs
    settle_s: float = 0.5
    timeout_s: float = 60.0
    beat_s: float = 0.2        # heartbeat/poll period while supervising
    dead_after_s: float = 3.0  # peer heartbeat staleness => host lost
    grace_s: float = 5.0       # SIGTERM -> SIGKILL when stopping a child
    max_generations: int = 32
    env: Dict[str, Optional[str]] = field(default_factory=dict)
    # None value = remove the variable from the child environment.


class ElasticAgent:
    def __init__(self, cfg: AgentConfig):
        self.cfg = cfg
        self.rdzv = Rendezvous(
            cfg.rdzv_dir, cfg.host_id, min_hosts=cfg.min_hosts,
            settle_s=cfg.settle_s, timeout_s=cfg.timeout_s)
        self._log = print

    # -- child lifecycle -----------------------------------------------

    def _child_env(self, generation: int, world: int, rank: int,
                   coordinator: str) -> Dict[str, str]:
        env = dict(os.environ)
        for key, val in self.cfg.env.items():
            if val is None:
                env.pop(key, None)
            else:
                env[key] = val
        env["TPUNET_ELASTIC_GENERATION"] = str(generation)
        env["TPUNET_ELASTIC_WORLD"] = str(world)
        env["TPUNET_ELASTIC_RANK"] = str(rank)
        env["TPUNET_ELASTIC_HOST"] = self.cfg.host_id
        if world > 1:
            addr, _, port = coordinator.rpartition(":")
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       # One child a host: local rank 0 of its host.
                       LOCAL_RANK="0", MASTER_ADDR=addr, MASTER_PORT=port)
        else:
            # A shrunk-to-one world must boot without a group: stale
            # rendezvous vars would make the child wait for dead peers.
            for key in LAUNCHER_VARS:
                env.pop(key, None)
        return env

    def _launch(self, generation: int, world: int, rank: int,
                coordinator: str) -> subprocess.Popen:
        argv = list(self.cfg.command)
        if generation > 0 or events.read_run_id(self.cfg.run_dir):
            # Any prior incarnation left state: resume (keeps run_id,
            # keeps metrics.jsonl, restores the last intact
            # checkpoint; a checkpoint-less resume degrades to a
            # fresh start on the same stream).
            argv.append("--resume")
        log_dir = os.path.join(self.cfg.run_dir, "elastic", "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(
            log_dir, f"gen{generation:03d}-{self.cfg.host_id}.log")
        # Child output goes to a FILE, never a pipe: the agent drains
        # nothing, so a chatty child can never fill a pipe and wedge
        # mid-collective.
        log_file = open(log_path, "ab")
        try:
            # The agent supervises this child for its whole life (the
            # loop below is its registry); flightrec's THREADS
            # registry does not exist in this torch-free process.
            child = subprocess.Popen(
                argv, stdout=log_file, stderr=subprocess.STDOUT,
                env=self._child_env(generation, world, rank,
                                    coordinator))
        finally:
            log_file.close()
        self._log(f"[elastic {self.cfg.host_id}] gen {generation}: "
                  f"launched pid {child.pid} rank {rank}/{world} "
                  f"(log: {log_path})")
        return child

    def _stop_child(self, child: subprocess.Popen) -> None:
        """SIGTERM (a wedged child may still flush a checkpoint from
        its writer thread), bounded grace, then SIGKILL."""
        if child.poll() is not None:
            return
        try:
            child.send_signal(signal.SIGTERM)
        except OSError:
            return
        deadline = time.monotonic() + self.cfg.grace_s
        while child.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if child.poll() is None:
            child.kill()
            child.wait()

    # -- supervision ---------------------------------------------------

    def _supervise(self, child: subprocess.Popen, generation: int,
                   hosts: List[str]) -> Tuple[str, object]:
        """Wait for the child or for a membership-change signal.
        Returns ``("exit", returncode)`` or ``("peer", why)``."""
        started = time.monotonic()
        while True:
            rc = child.poll()
            if rc is not None:
                return ("exit", rc)
            self.rdzv.heartbeat()
            if self.rdzv.latest_generation() > generation:
                return ("peer", "new_generation")
            gone = (self.rdzv.gone() & set(hosts)) - {self.cfg.host_id}
            if gone:
                return ("peer", f"host_left:{','.join(sorted(gone))}")
            if time.monotonic() - started > self.cfg.dead_after_s:
                stale = self.rdzv.stale_peers(hosts,
                                              self.cfg.dead_after_s)
                if stale:
                    # A silent peer: its agent died with its host (no
                    # gone marker) — declare it lost.
                    for host in stale:
                        self.rdzv.mark_gone(host)
                    return ("peer",
                            f"host_lost:{','.join(sorted(stale))}")
            if self.rdzv.join_requests():
                return ("peer", "join")
            time.sleep(self.cfg.beat_s)

    # -- membership records --------------------------------------------

    def _emit_change(self, *, generation: int, hosts: List[str],
                     prev_hosts: List[str], cause: str,
                     detect_t: float) -> None:
        old_w, new_w = len(prev_hosts), len(hosts)
        event = ("shrink" if new_w < old_w
                 else "grow" if new_w > old_w else "restart")
        lost = sorted(set(prev_hosts) - set(hosts))
        record = events.build_elastic_record(
            event, cause=cause, generation=generation,
            old_world=old_w, new_world=new_w, hosts=hosts,
            lost=lost or None,
            step=self._latest_ckpt_step(),
            recovery_s=time.monotonic() - detect_t)
        events.append_elastic_record(self.cfg.run_dir, record)
        self._log(f"[elastic {self.cfg.host_id}] {event}: world "
                  f"{old_w}->{new_w} gen {generation} cause={cause}")

    def _latest_ckpt_step(self) -> Optional[int]:
        """Best-effort committed-checkpoint stamp for announcements
        and records: the step (the epoch) of ``state_meta.json``, which
        the checkpointer renames into place after ``state.pt``; a write
        in progress is a ``.part`` file and is not read."""
        try:
            with open(os.path.join(self.cfg.run_dir, STATE_META)) as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _leave_evicted(self, evict: dict, generation: int,
                       world: int) -> int:
        """This host is the one the agreed evict names: record it, mark
        this host gone and leave the pod."""
        events.append_elastic_record(
            self.cfg.run_dir, events.build_elastic_record(
                "evict", cause=str(evict.get("reason", "evicted")),
                generation=generation, old_world=world,
                new_world=world - 1, lost=[self.cfg.host_id],
                detail=evict.get("detail") or None))
        self.rdzv.mark_gone()
        self._log(f"[elastic {self.cfg.host_id}] evicted "
                  f"({evict.get('reason')}); leaving pod")
        return EXIT_DONE

    # -- main loop -----------------------------------------------------

    def run(self) -> int:
        cfg = self.cfg
        generation = max(self.rdzv.latest_generation(), 0)
        restarts_left = cfg.max_restarts
        prev_hosts: Optional[List[str]] = None
        cause = ""
        detect_t = time.monotonic()
        for _ in range(cfg.max_generations):
            info = {"addr": cfg.addr, "port": _free_port(),
                    "ckpt_step": self._latest_ckpt_step()}
            self.rdzv.announce(generation, info)
            self.rdzv.heartbeat()
            try:
                members = self.rdzv.gather(generation)
            except QuorumError as e:
                events.append_elastic_record(
                    cfg.run_dir, events.build_elastic_record(
                        "quorum_failed", cause=str(e),
                        generation=generation,
                        old_world=(len(prev_hosts)
                                   if prev_hosts else None)))
                self._log(f"[elastic {cfg.host_id}] {e}")
                return EXIT_QUORUM
            hosts = [h for h, _ in members]
            rank = hosts.index(cfg.host_id)
            world = len(members)
            coordinator = (f"{members[0][1].get('addr', cfg.addr)}:"
                           f"{members[0][1].get('port', 0)}")
            if rank == 0:
                if prev_hosts is not None:
                    self._emit_change(generation=generation,
                                      hosts=hosts,
                                      prev_hosts=prev_hosts,
                                      cause=cause, detect_t=detect_t)
                    evict = events.read_evict_marker(cfg.run_dir)
                    if evict is None or evict.get("host") in \
                            self.rdzv.gone():
                        # Only once the evicted host has seen it and left.
                        events.clear_evict_marker(cfg.run_dir)
                # Clear ALL outstanding join requests, not just the
                # ones that made it into this membership: a joiner
                # that died between request_join() and announcing
                # would otherwise leave a stale request that trips
                # every generation's supervise loop into an immediate
                # re-rendezvous and churns a healthy pod to the
                # generation budget. A live-but-slow joiner self-
                # heals: its own child fails to rendezvous, its agent
                # announces the next generation, and the pod grows
                # then.
                for joiner in self.rdzv.join_requests():
                    self.rdzv.clear_join(joiner)
                events.write_agent_state(cfg.run_dir, {
                    "generation": generation, "world": world,
                    "hosts": hosts, "time": time.time()})
            child = self._launch(generation, world, rank, coordinator)
            verdict, payload = self._supervise(child, generation, hosts)
            if verdict == "peer":
                # A peer announced the next generation, or left, while
                # this child was still stopping: read the evict marker
                # now, before the next generation's rank 0 clears it, or
                # an evicted host would rejoin, and a survivor that saw
                # the evicted host's gone marker first would record
                # host_left (deviations from tpunet's agent, whose peer
                # path skips the marker).
                evict = events.read_evict_marker(cfg.run_dir)
                self._stop_child(child)
                if evict is not None:
                    if evict.get("host") == cfg.host_id:
                        return self._leave_evicted(evict, generation, world)
                    cause = "evict"
                else:
                    cause = str(payload).split(":")[0]
                detect_t = time.monotonic()
                prev_hosts = hosts
                generation = max(generation + 1,
                                 self.rdzv.latest_generation())
                continue
            rc = int(payload)  # verdict == "exit"
            detect_t = time.monotonic()
            if events.is_done(cfg.run_dir):
                self._log(f"[elastic {cfg.host_id}] training complete "
                          f"(gen {generation})")
                return EXIT_DONE
            evict = events.read_evict_marker(cfg.run_dir)
            if evict is not None:
                if evict.get("host") == cfg.host_id:
                    return self._leave_evicted(evict, generation, world)
                cause = "evict"
            elif rc == 0:
                cause = "preempted"
            else:
                restarts_left -= 1
                if restarts_left < 0:
                    self.rdzv.mark_gone()
                    self._log(f"[elastic {cfg.host_id}] child failed "
                              f"(rc {rc}) with no restart budget "
                              "left; leaving pod")
                    return EXIT_RESTARTS
                cause = "failed"
            prev_hosts = hosts
            generation = max(generation + 1,
                             self.rdzv.latest_generation())
        self._log(f"[elastic {cfg.host_id}] generation budget "
                  f"({cfg.max_generations}) exhausted")
        return EXIT_GENERATIONS
