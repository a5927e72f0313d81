"""Replica process lifecycle: spawn, drain-then-restart, respawn.

A copy of ``tpunet/router/supervisor.py`` that launches the port's
serve CLI, ``python -m tpunet_torch.serve`` (on the card unless the
passthrough says ``--device cpu``). The JAX package's children get
``--aot-cache`` pointed at a shared program store; the port has no such
store (``tpunet_torch.config.AOT_CACHE_SCOPED_OUT``), so ``aot_cache``
is refused here and no child is ever spawned with ``--aot-cache``. A
port child compiles no per-shape program, so a respawn costs one
process boot and the model's first steps.

Supervisor mode is what turns the router from a proxy into a fleet
operator: it launches the serve children (one per replica slot),
restarts the ones the control loop evicts, and scales the set up/down
on the policy's decisions.

Stopping is drain-then-kill: SIGTERM triggers the serve entry's
graceful drain (in-flight streams finish, the final ``obs_serve``
record flushes), and only a child still alive after ``drain_grace_s``
gets SIGKILL. Each child's stdout/stderr lands in
``<dir>/replica-<i>.log`` next to its own metrics dir, so a dead
replica leaves its flight-recorder crash report and its log where
the operator can find them.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from tpunet_torch.config import AOT_CACHE_SCOPED_OUT
from tpunet_torch.obs.flightrec import register_thread


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind-then-close; the tiny race
    window is acceptable for dev/test replica fleets — production
    deployments pin ports)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class ReplicaProcess:
    """One spawned serve child."""

    def __init__(self, index: int, port: int, proc: subprocess.Popen,
                 run_id: str, log_path: str):
        self.index = index
        self.port = port
        self.proc = proc
        self.run_id = run_id
        self.log_path = log_path
        self.spawned_t = time.monotonic()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None


class Supervisor:
    """Spawns and reaps ``python -m tpunet_torch.serve`` replica children.

    ``serve_args`` is the passthrough argv tail (model architecture,
    checkpoint dir, slots...) every child shares; per-child --port,
    --run-id and --metrics-dir are appended here. The supervisor
    itself is single-threaded (the router's control loop drives it)
    but registers in the flightrec host-thread registry so the
    processes it owns are inventoried next to every other background
    resource."""

    def __init__(self, serve_args: List[str], *, directory: str = "",
                 host: str = "127.0.0.1", drain_grace_s: float = 30.0,
                 run_prefix: str = "router-replica",
                 aot_cache: str = "", chaos: str = ""):
        # tpunet's signature, so its callers get the reason rather
        # than a TypeError; the passthrough may not smuggle it in.
        if aot_cache or any(a.split("=", 1)[0] == "--aot-cache"
                            for a in serve_args):
            raise NotImplementedError(AOT_CACHE_SCOPED_OUT)
        self.serve_args = list(serve_args)
        self.directory = directory
        self.host = host
        self.drain_grace_s = drain_grace_s
        self.run_prefix = run_prefix
        # Router-level chaos spec (tpunet_torch/serve/chaos.py grammar
        # plus the ``replica=I`` scope key): each child is launched with
        # exactly the events that address its index. A respawned
        # child re-arms its events — its counters restart with it.
        self.chaos = chaos
        self.spawned_total = 0
        self._procs: Dict[int, ReplicaProcess] = {}
        # Inventory-only registration (stall budget 0): the supervisor
        # has no thread of its own — the control loop beats for it —
        # but its children must be discoverable in crash reports.
        self._handle = register_thread("router-supervisor")

    def child_argv(self, index: int, port: int, run_id: str) -> List[str]:
        argv = [sys.executable, "-m", "tpunet_torch.serve",
                "--host", self.host, "--port", str(port),
                "--run-id", run_id]
        if self.directory:
            argv += ["--metrics-dir",
                     os.path.join(self.directory, f"replica-{index}")]
        if self.chaos and "--chaos" not in self.serve_args:
            from tpunet_torch.serve.chaos import spec_for_replica
            spec = spec_for_replica(self.chaos, index)
            if spec:
                argv += ["--chaos", spec]
        return argv + self.serve_args

    def spawn(self, index: int,
              port: Optional[int] = None) -> ReplicaProcess:
        """Launch replica ``index`` (an OS-assigned port unless
        pinned) and return its process record. The caller polls the
        replica's /healthz for readiness — spawn never blocks on the
        child's compile."""
        port = port if port else free_port(self.host)
        run_id = f"{self.run_prefix}-{index}"
        log_path = ""
        stdout = subprocess.DEVNULL
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            log_path = os.path.join(self.directory,
                                    f"replica-{index}.log")
            stdout = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                self.child_argv(index, port, run_id),
                stdout=stdout, stderr=subprocess.STDOUT,
                start_new_session=True)
        finally:
            if stdout is not subprocess.DEVNULL:
                stdout.close()
        record = ReplicaProcess(index, port, proc, run_id, log_path)
        self._procs[index] = record
        self.spawned_total += 1
        self._handle.beat("idle")
        return record

    def get(self, index: int) -> Optional[ReplicaProcess]:
        return self._procs.get(index)

    def stop(self, index: int, *, drain: bool = True,
             grace_s: Optional[float] = None) -> bool:
        """Drain-then-stop one child. Returns True when it exited
        inside the grace budget (False = SIGKILL was needed)."""
        record = self._procs.get(index)
        if record is None or not record.alive():
            return True
        grace = self.drain_grace_s if grace_s is None else grace_s
        clean = True
        if drain and grace > 0:
            try:
                record.proc.send_signal(signal.SIGTERM)
            except OSError:
                return True
            try:
                record.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                clean = False
        else:
            clean = False
        if record.alive():
            try:
                record.proc.kill()
            except OSError:
                pass
            try:
                record.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        return clean

    def kill(self, index: int) -> None:
        """Immediate SIGKILL (eviction of a wedged/crashed child —
        drain would block on a dead engine)."""
        self.stop(index, drain=False)

    def respawn(self, index: int) -> ReplicaProcess:
        """Stop (if needed) and relaunch replica ``index`` on a fresh
        port."""
        self.kill(index)
        return self.spawn(index)

    def stop_all(self, *, drain: bool = True,
                 grace_s: Optional[float] = None) -> None:
        """Stop every child against ONE shared grace budget: SIGTERM
        them all first, then wait — shutdown latency is one drain,
        not N sequential ones. ``grace_s`` overrides the budget (the
        router's drain passes what remains after waiting out in-flight
        failovers, so the whole shutdown honors ``drain_grace_s``
        once)."""
        grace = self.drain_grace_s if grace_s is None else grace_s
        alive = [r for r in self._procs.values() if r.alive()]
        if drain and grace > 0:
            for record in alive:
                try:
                    record.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
            deadline = time.monotonic() + grace
            for record in alive:
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    try:
                        record.proc.wait(timeout=remaining)
                    except subprocess.TimeoutExpired:
                        pass
        for record in alive:
            if record.alive():
                try:
                    record.proc.kill()
                except OSError:
                    pass
                try:
                    record.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass

    def remove(self, index: int) -> None:
        self.stop(index, drain=True)
        self._procs.pop(index, None)
