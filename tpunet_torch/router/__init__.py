"""Routing + autoscaling front tier over N serving replicas.

A copy of ``tpunet/router/`` (framework-free: stdlib threads and HTTP),
in front of ``python -m tpunet_torch.serve`` replicas. The routing,
affinity keys, probes, eviction, autoscale decisions, ``obs_router``
records and failover journal are the JAX package's, so a fleet that
mixes both packages' replicas routes alike behind either router. Only
the spawned command and the AOT store differ: the supervisor launches
the port's serve CLI, and ``--aot-cache`` is refused
(``tpunet_torch.config.AOT_CACHE_SCOPED_OUT``).

The serving engine (``tpunet_torch/serve/``) is one replica: one KV-slot
pool, one ``/v1/generate`` endpoint. This package is the tier that
makes a *fleet* of them look like one endpoint — and acts on the
fleet signals the obs subsystems already produce:

- ``replica``    — per-replica handle: live queue-depth/slot
  occupancy probes (``/healthz`` + ``/metrics``), state machine
  (starting/healthy/draining/backoff/dead/evicted), failure streaks.
- ``balance``    — replica selection: least-loaded by probed load
  score, with session/prefix-affinity rendezvous hashing so
  shared-prompt traffic lands on the replica whose KV is warm.
- ``supervisor`` — replica lifecycle: spawns ``python -m
  tpunet_torch.serve`` children, drain-then-restart (SIGTERM -> graceful
  drain -> SIGKILL), respawn with backoff.
- ``policy``     — hysteresis autoscale over fleet queue depth per
  slot and TTFT SLO burn.
- ``core``       — the Router: control loop (probe -> evict ->
  respawn -> scale -> emit), ``obs_router`` records, webhook-driven
  eviction (``AlertWebhook`` POSTs land on ``POST /webhook``).
- ``journal``    — bounded in-memory journal of in-flight streamed
  requests: the resume state mid-stream failover replays onto a
  surviving replica (docs/serving.md "Mid-stream failover &
  serve-tier chaos").
- ``frontend``   — stdlib threaded HTTP proxy: ``/v1/generate``
  (streaming and blocking, with mid-stream failover),
  ``/v1/classify``, ``/healthz``, ``/metrics``, ``/replicas``,
  ``/webhook``.

A port replica compiles no per-shape program (its hand kernels are
built once under ``build/tpunet_torch/``), so a scale-up or respawn
boots without the JAX package's AOT program store.

Entry point: ``python -m tpunet_torch.router`` (docs/serving.md
"Routing & autoscaling").
"""

from tpunet_torch.router.balance import affinity_key, pick_replica
from tpunet_torch.router.core import Router
from tpunet_torch.router.frontend import RouterServer
from tpunet_torch.router.journal import RequestJournal
from tpunet_torch.router.policy import AutoscalePolicy
from tpunet_torch.router.records import build_router_record
from tpunet_torch.router.replica import ReplicaHandle
from tpunet_torch.router.supervisor import Supervisor

__all__ = [
    "AutoscalePolicy", "ReplicaHandle", "RequestJournal", "Router",
    "RouterServer", "Supervisor", "affinity_key",
    "build_router_record", "pick_replica",
]
