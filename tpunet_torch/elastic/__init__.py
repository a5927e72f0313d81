"""Elastic grow/shrink training: chaos, rendezvous, and the agent; the
port of ``tpunet/elastic/``.

- ``chaos``      — deterministic fault injection (``--chaos`` on the
  train CLI): SIGKILL mid-step and mid-checkpoint-write, SIGTERM
  preemption with escalation, slow-host delay, transient checkpoint
  IO errors (docs/elasticity.md grammar);
- ``rendezvous`` — filesystem rendezvous for surviving hosts:
  generation-numbered announcements, a timeout-bounded gather with a
  clean "cannot form quorum" path, departure markers, heartbeats and
  join requests (grow);
- ``agent``      — the per-host supervisor (``python -m
  tpunet_torch.elastic``): launches the trainer as a child process,
  detects child death / peer loss / preemption stops, re-rendezvous
  with the survivors, and relaunches the child against the resized
  world with ``--resume``; the run keeps its ``run_id`` and its
  ``metrics.jsonl`` across generations;
- ``events``     — the ``obs_elastic`` record kind and the agent/trainer
  marker files (docs/metrics_schema.md).

``events``, ``rendezvous`` and ``agent`` are stdlib only, so the agent
runs where torch cannot be imported; ``chaos`` records into the port's
flight recorder and is imported on first use of its names here.
"""

from __future__ import annotations

from tpunet_torch.elastic.events import (ELASTIC_KIND, append_elastic_record,
                                         build_elastic_record)
from tpunet_torch.elastic.rendezvous import QuorumError, Rendezvous

__all__ = [
    "Chaos", "ChaosSpecError", "ELASTIC_KIND", "QuorumError",
    "Rendezvous", "append_elastic_record", "build_elastic_record",
]


def __getattr__(name: str):
    if name in ("Chaos", "ChaosSpecError"):
        from tpunet_torch.elastic import chaos
        return getattr(chaos, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
