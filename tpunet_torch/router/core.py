"""The Router: fleet state + the control loop that acts on it.

A copy of ``tpunet/router/core.py``: the ``router_*`` instruments
keep the JAX package's names.

Everything the fleet's eyes already see — queue depth, slot
occupancy, TTFT windows, webhook pages — converges here and turns
into actions:

- **probe** every replica each round (``/healthz`` + ``/metrics``);
- **evict** replicas past their failure budget (or named by an
  AlertWebhook page: straggler / crash / thread_stalled) and, in
  supervisor mode, **respawn** them after a backoff (a port child
  builds no per-shape program, so recovery is one process boot);
- **scale** the replica set on the hysteresis policy's decision
  (supervisor mode spawns/drains children; external mode emits the
  decision as advice);
- **emit** ``obs_router`` window records through the registry sinks
  (metrics.jsonl, exporters, the alert webhook for event records).

The router process never touches a device: probing, proxying, and
process supervision are stdlib work, so one router fronts any number
of accelerator-bound replicas without competing for their HBM.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from tpunet_torch.obs import flightrec
from tpunet_torch.obs.registry import Registry
from tpunet_torch.obs.tracing import observe_trace
from tpunet_torch.router import replica as rstate
from tpunet_torch.router.balance import affinity_key, pick_replica
from tpunet_torch.router.journal import RequestJournal
from tpunet_torch.router.policy import (SCALE_DOWN, SCALE_UP,
                                        AutoscalePolicy)
from tpunet_torch.router.records import (build_router_event,
                                         build_router_record)
from tpunet_torch.router.replica import ReplicaHandle
from tpunet_torch.router.supervisor import Supervisor

#: AlertWebhook page reasons the router treats as eviction triggers.
#: Everything else (loss spikes, gauge predicates...) is a trainer
#: concern and is acknowledged without action.
EVICT_REASONS = ("straggler", "crash", "thread_stalled")


class Router:
    """Replica set + control loop. The HTTP frontend
    (tpunet_torch/router/frontend.py) proxies through ``pick`` /
    ``note_*``; ``python -m tpunet_torch.router`` wires both."""

    def __init__(self, cfg, *, replica_urls: List[str] = (),
                 supervisor: Optional[Supervisor] = None,
                 n_replicas: int = 0, registry: Optional[Registry] = None,
                 clock=time.monotonic):
        self.cfg = cfg
        self.supervisor = supervisor
        self.registry = registry if registry is not None else Registry()
        if not self.registry.identity():
            import os
            import socket
            self.registry.set_identity(
                run_id=cfg.run_id
                or f"router-{socket.gethostname()}-{os.getpid()}",
                process_index=0, host=socket.gethostname())
        self._clock = clock
        self.policy = AutoscalePolicy(cfg, clock=clock)
        # SLO engine (tpunet_torch/obs/slo.py): armed by --slo-policy
        # and/or the canary prober; None keeps the whole path zero-cost.
        self.slo = None
        if getattr(cfg, "slo_policy", "") \
                or getattr(cfg, "probe_every_s", 0.0) > 0:
            from tpunet_torch.obs.slo import SloEngine, load_policy
            self.slo = SloEngine(
                load_policy(getattr(cfg, "slo_policy", "")),
                registry=self.registry, clock=clock)
        # Mid-stream failover journal (tpunet_torch/router/journal.py):
        # owned here so the drain path can wait for in-flight
        # failovers instead of orphaning them with the frontend.
        self.journal = RequestJournal(
            getattr(cfg, "failover_journal_tokens", 4096))
        self.replicas: List[ReplicaHandle] = []
        self._boot_deadline: Dict[str, float] = {}
        self._respawn_at: Dict[str, float] = {}
        # Names of replicas whose PROCESS this router owns: only these
        # are killed/respawned on eviction — an external --replica URL
        # in a mixed fleet is taken out of rotation, never replaced by
        # a locally spawned child the operator didn't ask for.
        self._supervised: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._handle = None
        self._started = clock()
        self._last_emit = clock()
        self._next_index = 0
        self.error: Optional[str] = None
        for url in replica_urls:
            self._add_handle(url)
        if supervisor is not None:
            for _ in range(n_replicas):
                self._spawn_next()

    # -- replica set -----------------------------------------------------

    def _add_handle(self, url: str) -> ReplicaHandle:
        handle = ReplicaHandle(f"r{self._next_index}", url,
                               clock=self._clock)
        self._next_index += 1
        self._boot_deadline[handle.name] = (self._clock()
                                            + self.cfg.boot_timeout_s)
        self.replicas.append(handle)
        return handle

    def _spawn_next(self) -> ReplicaHandle:
        index = self._next_index
        proc = self.supervisor.spawn(index)
        handle = self._add_handle(
            f"http://{self.supervisor.host}:{proc.port}")
        self._supervised.add(handle.name)
        return handle

    def replicas_view(self) -> List[dict]:
        rows = [r.view() for r in list(self.replicas)]
        if self.supervisor is not None:
            for row in rows:
                proc = self.supervisor.get(int(row["name"][1:]))
                if proc is not None:
                    row["pid"] = proc.pid
                    row["alive"] = proc.alive()
        return rows

    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas
                   if r.state == rstate.HEALTHY)

    # -- frontend surface ------------------------------------------------

    def pick(self, body: dict, exclude=()):
        """(replica, affinity_hit) for one request body (None when
        nothing routable)."""
        key = affinity_key(body, self.cfg.affinity_prefix)
        rep, hit = pick_replica(
            list(self.replicas), key,
            affinity_slack=self.cfg.affinity_slack, exclude=exclude)
        if rep is not None and hit:
            self.registry.counter("router_affinity_hits_total").inc()
        return rep, hit

    def note_routed(self, rep: ReplicaHandle) -> None:
        self.registry.counter("router_requests_total").inc()
        rep.note_routed()

    def note_rerouted(self, rep: ReplicaHandle) -> None:
        self.registry.counter("router_rerouted_total").inc()
        rep.note_failed()

    def note_rejected(self, *, synthetic: bool = False) -> None:
        """No routable replica. ``synthetic`` marks the prober's own
        traffic — the prober self-judges via ``note_probe`` (with its
        warmup gate), so the passive feed skips it here too."""
        self.registry.counter("router_rejected_total").inc()
        if self.slo is not None and not synthetic:
            self.slo.note_request(False)

    def note_failover(self, rep: ReplicaHandle, *,
                      tokens: int) -> None:
        """One mid-stream failover began: the stream's owner died (or
        wedged into eviction) after ``tokens`` tokens reached the
        client and a resume is being submitted to a survivor."""
        self.registry.counter("router_failovers_total").inc()
        flightrec.record("router",
                         f"failover from {rep.name} at {tokens} tok")
        self.registry.emit("obs_router", build_router_event(
            "failover", replica=rep.name, url=rep.url,
            cause="replica_failed_mid_stream",
            detail={"tokens_relayed": tokens}))

    def observe_e2e(self, seconds: float, *,
                    synthetic: bool = False) -> None:
        """One request finished end-to-end. ``synthetic`` marks the
        prober's own traffic — it judges itself client-side and feeds
        the SLO engine through ``note_probe``, so the passive feed
        skipping it keeps every probe counted exactly once."""
        self.registry.histogram("router_e2e_s").observe(seconds)
        if self.slo is not None and not synthetic:
            self.slo.note_request(True)
            self.slo.note_latency("e2e", seconds)

    def note_trace(self, record: dict) -> None:
        """One router-hop ``obs_trace`` span closed (sampled request
        finished, or an unsampled one earned tail capture via
        trace-all-on-error): bump the ``trace_*`` instruments and ship
        the record through the sinks."""
        observe_trace(self.registry, record)
        self.registry.emit("obs_trace", record)

    def replica_failed(self, rep: ReplicaHandle) -> None:
        """A proxied request hit a transport failure: probe it NOW
        (off the probe cadence) so a dead replica leaves the routable
        set within one request, not one probe interval. Same guards
        as the control loop: boot grace protects a respawning child
        from a stale in-flight failure, and an already-evicted
        replica is not evicted again."""
        if rep.state in (rstate.DEAD, rstate.EVICTED):
            return
        if not rep.probe(self.cfg.probe_timeout_s):
            in_boot = (rep.state == rstate.STARTING
                       and self._clock() < self._boot_deadline.get(
                           rep.name, 0.0))
            if not in_boot \
                    and rep.fail_streak >= self.cfg.unhealthy_after:
                self._evict(rep, cause="probe_failures")

    # -- webhook consumption ---------------------------------------------

    def on_page(self, payload: dict) -> bool:
        """Consume one AlertWebhook POST (the documented wire format:
        kind/reason/run_id/detail). A straggler / crash /
        thread_stalled page naming a replica's run_id evicts it;
        anything else is acknowledged without action. Returns True
        when an eviction was triggered."""
        reason = str(payload.get("reason") or "")
        kind = str(payload.get("kind") or "")
        if reason not in EVICT_REASONS and kind != "obs_crash":
            return False
        run_id = str(payload.get("run_id")
                     or payload.get("stream") or "")
        if not run_id:
            return False
        # Fleet-aggregator pages key streams as "run_id/process_index";
        # replicas are single-process, so strip that suffix and match
        # EXACTLY (a prefix match would evict router-replica-1 on a
        # page for router-replica-10).
        run_id = run_id.split("/", 1)[0]
        target = None
        for rep in list(self.replicas):
            if rep.run_id and run_id == rep.run_id:
                target = rep
                break
        if target is None or target.state in (rstate.DEAD,
                                              rstate.EVICTED):
            return False
        self._evict(target, cause=f"webhook:{reason or kind}",
                    detail=payload)
        return True

    # -- control loop ----------------------------------------------------

    def start(self) -> "Router":
        self._handle = flightrec.register_thread("router-control",
                                                 stall_after_s=120.0)
        flightrec.record("router",
                         f"control start replicas={len(self.replicas)}")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpunet-router-control")
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._handle.beat("busy")
                self._round()
                self._handle.beat("idle")
                self._stop.wait(self.cfg.probe_interval_s)
        except BaseException as e:  # noqa: BLE001 — control-loop death
            # flips the router's /healthz; the frontend keeps proxying
            # on the last-known replica states.
            self.error = f"{type(e).__name__}: {e}"
            flightrec.record("router", f"control error: {e}")

    def _round(self) -> None:
        """One control round: probe -> evict -> respawn -> scale ->
        emit."""
        reg = self.registry
        now = self._clock()
        for rep in list(self.replicas):
            t0 = time.perf_counter()
            ok = rep.probe(self.cfg.probe_timeout_s)
            reg.histogram("router_probe_s").observe(
                time.perf_counter() - t0)
            if not ok:
                reg.counter("router_probe_failures_total").inc()
                in_boot = (rep.state == rstate.STARTING
                           and now < self._boot_deadline.get(
                               rep.name, 0.0))
                if not in_boot \
                        and rep.fail_streak >= self.cfg.unhealthy_after \
                        and rep.state not in (rstate.DEAD,
                                              rstate.EVICTED):
                    self._evict(rep, cause="probe_failures")
        self._respawn_due(now)
        self._autoscale()
        self._export_gauges()
        if self.slo is not None:
            # Every round, not just on emit cadence: burn-rate pages
            # must fire at probe-loop latency (the record bodies are
            # discarded here; emit_record re-evaluates on its cadence).
            self.slo.evaluate()
        if self.cfg.emit_every_s > 0 \
                and now - self._last_emit >= self.cfg.emit_every_s:
            self.emit_record()

    def _evict(self, rep: ReplicaHandle, *, cause: str,
               detail: Optional[dict] = None) -> None:
        """Take a replica out of rotation (and, when this router owns
        its process, kill it and schedule the respawn). Idempotent:
        concurrent failure reports evict once."""
        with self._lock:
            if rep.state in (rstate.DEAD, rstate.EVICTED):
                return
            rep.mark(rstate.EVICTED if cause.startswith("webhook")
                     else rstate.DEAD)
        self.registry.counter("router_evictions_total").inc()
        flightrec.record("router", f"evict {rep.name} {cause}")
        self.registry.emit("obs_router", build_router_event(
            "evict", replica=rep.name, url=rep.url, cause=cause,
            detail=detail))
        if self.supervisor is not None \
                and rep.name in self._supervised:
            index = int(rep.name[1:])
            self.supervisor.kill(index)
            self._respawn_at[rep.name] = (self._clock()
                                          + self.cfg.respawn_backoff_s)

    def _respawn_due(self, now: float) -> None:
        if self.supervisor is None:
            return
        for rep in list(self.replicas):
            due = self._respawn_at.get(rep.name)
            if due is None or now < due:
                continue
            del self._respawn_at[rep.name]
            index = int(rep.name[1:])
            proc = self.supervisor.respawn(index)
            rep.reset_for_respawn(
                f"http://{self.supervisor.host}:{proc.port}")
            self._boot_deadline[rep.name] = (self._clock()
                                             + self.cfg.boot_timeout_s)
            self.registry.counter("router_respawns_total").inc()
            flightrec.record("router",
                             f"respawn {rep.name} port={proc.port}")
            self.registry.emit("obs_router", build_router_event(
                "respawn", replica=rep.name, url=rep.url,
                cause="evicted"))

    def _fleet_ttft_p99(self) -> Optional[float]:
        """Worst healthy replica's window TTFT p99 from the probes —
        a scale SIGNAL, deliberately not a merged fleet percentile
        (the aggregator owns the honest merge; the policy only needs
        'someone is burning the SLO')."""
        vals = [r.ttft_p99_s for r in self.replicas
                if r.state == rstate.HEALTHY
                and r.ttft_p99_s is not None]
        return max(vals) if vals else None

    def _autoscale(self) -> None:
        live = [r for r in self.replicas
                if r.state in (rstate.HEALTHY, rstate.STARTING,
                               rstate.DRAINING)]
        healthy = [r for r in live if r.state == rstate.HEALTHY]
        queue_depth = sum(r.queue_depth for r in healthy)
        slots = sum(r.slots for r in healthy)
        decision = self.policy.observe(
            queue_depth=queue_depth, slots=slots,
            ttft_p99_s=self._fleet_ttft_p99(), replicas=len(live))
        if decision is None:
            return
        old = len(live)
        if decision == SCALE_UP:
            self.registry.counter("router_scale_ups_total").inc()
            if self.supervisor is not None:
                handle = self._spawn_next()
                flightrec.record("router", f"scale_up {handle.name}")
            self.registry.emit("obs_router", build_router_event(
                SCALE_UP, cause="policy", old_replicas=old,
                new_replicas=old + 1))
        elif decision == SCALE_DOWN:
            victim = min(healthy, default=None,
                         key=lambda r: (r.load_score(), r.name))
            if victim is None:
                return         # nothing drainable this round
            self.registry.counter("router_scale_downs_total").inc()
            victim.mark(rstate.DRAINING)
            if self.supervisor is not None:
                self._drain_remove_async(victim)
            flightrec.record("router", f"scale_down {victim.name}")
            self.registry.emit("obs_router", build_router_event(
                SCALE_DOWN, replica=victim.name, cause="policy",
                old_replicas=old, new_replicas=max(0, old - 1)))

    def _drain_remove_async(self, rep: ReplicaHandle) -> None:
        """Drain-stop a scale-down victim off the control loop (the
        graceful drain can take drain_grace_s; probing must not
        stall behind it)."""
        index = int(rep.name[1:])

        def work() -> None:
            handle = flightrec.register_thread(
                f"router-drain-{rep.name}", stall_after_s=0.0)
            handle.beat("busy")
            self.supervisor.remove(index)
            with self._lock:
                if rep in self.replicas:
                    self.replicas.remove(rep)
                self._supervised.discard(rep.name)
            self._boot_deadline.pop(rep.name, None)
            handle.beat("idle")

        threading.Thread(target=work, daemon=True,
                         name=f"tpunet-router-drain-{rep.name}").start()

    # -- obs -------------------------------------------------------------

    def _export_gauges(self) -> None:
        reg = self.registry
        healthy = [r for r in self.replicas
                   if r.state == rstate.HEALTHY]
        reg.gauge("router_replicas").set(len(self.replicas))
        reg.gauge("router_replicas_healthy").set(len(healthy))
        reg.gauge("router_fleet_queue_depth").set(
            sum(r.queue_depth for r in healthy))
        reg.gauge("router_fleet_active_slots").set(
            sum(r.active_slots for r in healthy))
        reg.gauge("router_fleet_slots").set(
            sum(r.slots for r in healthy))
        burn = self.policy.slo_burn(self._fleet_ttft_p99())
        if burn is not None:
            reg.gauge("router_ttft_slo_burn").set(round(burn, 4))

    def emit_record(self, final: bool = False) -> None:
        now = self._clock()
        window = now - self._last_emit
        self._last_emit = now
        record = build_router_record(
            self.registry, replicas=self.replicas_view(),
            uptime_s=now - self._started, window_s=window,
            scale_decision=self.policy.last_decision,
            ttft_slo_burn=self.policy.slo_burn(self._fleet_ttft_p99()),
            final=final)
        from tpunet_torch.obs.flightrec.threads import THREADS
        THREADS.export_gauges(self.registry)
        self.registry.emit("obs_router", record)
        if self.slo is not None:
            for slo_record in self.slo.evaluate():
                self.registry.emit("obs_slo", slo_record)
        self.registry.reset_window()

    # -- lifecycle -------------------------------------------------------

    @property
    def healthy(self) -> bool:
        return (self.error is None and self._thread is not None
                and self._thread.is_alive())

    def drain(self) -> None:
        """Stop the control loop, wait out in-flight failovers, flush
        the final record, drain every supervised child. The failover
        wait and the children's graceful drain share ONE grace budget
        (``drain_grace_s``): a journaled request mid-failover is not
        orphaned, and a resumed stream is back in a replica's
        in-flight set where the child's own drain finishes it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        deadline = time.monotonic() + self.cfg.drain_grace_s
        while self.journal.active_failovers() \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        self.emit_record(final=True)
        if self.supervisor is not None:
            self.supervisor.stop_all(
                drain=True,
                grace_s=max(0.0, deadline - time.monotonic()))
