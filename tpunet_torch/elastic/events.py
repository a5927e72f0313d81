"""``obs_elastic`` records and the agent/trainer marker files, a copy of
``tpunet/elastic/events.py`` (stdlib only).

Elasticity events are part of the run's observable history: a shrink
that silently drops half the pod's throughput would poison every
cross-run comparison the run-history store makes. So every
membership change is one ``obs_elastic`` record (schema:
docs/metrics_schema.md) carrying the cause, the old/new world and
mesh, the restore stamp, and the recovery wall-clock — appended to
the SAME ``metrics.jsonl`` under the SAME ``run_id`` as the training
records it interrupts, so the stream stays one judgeable run.

Two writers exist on purpose:

- the **agent** (no torch, no registry) appends via
  ``append_elastic_record`` — identity-stamped from the persisted
  ``<run_dir>/run_id`` file, one atomic appended line;
- the **trainer** emits through ``Registry.emit`` (identity stamp,
  jsonl sink, live exporters, webhook) for the events it witnesses
  from inside: ``evict_requested`` when the watchdog hands it a
  straggler verdict, ``recovered`` once it has restored onto the new
  mesh.

Marker files are the agent/trainer contract (all under the shared run
directory, all single atomic writes):

- ``elastic/done``          — the trainer completed every epoch;
- ``elastic/evict.json``    — an agreed evict: names the process
  index/host being evicted so each agent knows whether it is the one
  leaving;
- ``elastic/state.json``    — the agent's generation bookkeeping
  (informational, refreshed per generation).
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Dict, List, Optional

ELASTIC_KIND = "obs_elastic"

#: Event vocabulary (docs/metrics_schema.md `obs_elastic`).
EVENTS = ("shrink", "grow", "restart", "evict", "evict_requested",
          "quorum_failed", "recovered")

_MARKER_DIR = "elastic"
_DONE = "done"
_EVICT = "evict.json"


def build_elastic_record(event: str, *, cause: str = "",
                         generation: Optional[int] = None,
                         old_world: Optional[int] = None,
                         new_world: Optional[int] = None,
                         old_mesh: Optional[Dict[str, int]] = None,
                         new_mesh: Optional[Dict[str, int]] = None,
                         hosts: Optional[List[str]] = None,
                         lost: Optional[List[str]] = None,
                         epoch: Optional[int] = None,
                         step: Optional[int] = None,
                         recovery_s: Optional[float] = None,
                         detail: Optional[dict] = None) -> dict:
    """One ``obs_elastic`` record body (no ``kind``/identity — the
    emitter stamps those)."""
    if event not in EVENTS:
        raise ValueError(f"unknown elastic event {event!r} "
                         f"(expected one of {EVENTS})")
    record: dict = {
        "event": event,
        # quorum failure is the one elastic event that means the run
        # is STOPPED, not reshaped — page it accordingly.
        "severity": "fatal" if event == "quorum_failed" else "warn",
    }
    if cause:
        record["cause"] = cause
    for key, val in (("generation", generation),
                     ("old_world", old_world), ("new_world", new_world),
                     ("old_mesh", old_mesh), ("new_mesh", new_mesh),
                     ("hosts", hosts), ("lost", lost),
                     ("epoch", epoch), ("step", step)):
        if val is not None:
            record[key] = val
    if recovery_s is not None:
        record["recovery_s"] = round(float(recovery_s), 3)
    if detail:
        record["detail"] = detail
    return record


def read_run_id(run_dir: str) -> str:
    """The persisted run identity (``<run_dir>/run_id``), or '' before
    the first trainer incarnation has written it."""
    path = os.path.join(run_dir, "run_id")
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return ""


def append_elastic_record(run_dir: str, record: dict) -> dict:
    """Agent-side emission: stamp kind + identity and append one line
    to the run's ``metrics.jsonl``. Safe while no trainer runs (the
    agent only writes between generations) and append-atomic like
    ``MetricsLogger.log``."""
    stamped = {
        "kind": ELASTIC_KIND,
        "run_id": read_run_id(run_dir),
        "process_index": 0,
        "host": socket.gethostname(),
        "time": round(time.time(), 3),
    }
    stamped.update(record)
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "metrics.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(stamped) + "\n")
    return stamped


# -- marker files ------------------------------------------------------


def _marker_path(run_dir: str, name: str) -> str:
    return os.path.join(run_dir, _MARKER_DIR, name)


def _write_marker(run_dir: str, name: str, payload: dict) -> None:
    os.makedirs(os.path.join(run_dir, _MARKER_DIR), exist_ok=True)
    path = _marker_path(run_dir, name)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def mark_done(run_dir: str) -> None:
    """Trainer: every configured epoch completed — agents stop
    relaunching."""
    _write_marker(run_dir, _DONE, {"time": time.time()})


def is_done(run_dir: str) -> bool:
    return os.path.isfile(_marker_path(run_dir, _DONE))


def write_evict_marker(run_dir: str, *, process_index: int, host: str,
                       reason: str, detail: Optional[dict] = None
                       ) -> bool:
    """Claim the evict slot for this replica — FIRST claim wins.

    In lockstep data parallelism a straggler slows every replica's
    measured step time, so several hosts' watchdogs may fire
    near-simultaneously; the marker is therefore an exclusive claim
    (atomic link-into-place): the first claimer is the replica the
    pod evicts, later claimers defer (returns False). The true
    straggler usually claims first — its delay is measured directly,
    the others' only after dispatch backpressure — but the guarantee
    is liveness (exactly one replica leaves), not perfect
    attribution (docs/elasticity.md)."""
    os.makedirs(os.path.join(run_dir, _MARKER_DIR), exist_ok=True)
    path = _marker_path(run_dir, _EVICT)
    tmp = f"{path}.claim.{host}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"process_index": int(process_index), "host": host,
                   "reason": reason, "detail": detail or {},
                   "time": time.time()}, f)
    try:
        os.link(tmp, path)   # atomic: fails iff a claim already won
        return True
    except FileExistsError:
        return False
    finally:
        os.unlink(tmp)


def read_evict_marker(run_dir: str) -> Optional[dict]:
    try:
        with open(_marker_path(run_dir, _EVICT)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def clear_evict_marker(run_dir: str) -> None:
    try:
        os.unlink(_marker_path(run_dir, _EVICT))
    except OSError:
        pass


def write_agent_state(run_dir: str, payload: dict) -> None:
    """Informational generation bookkeeping (rendered by humans and
    read back by the resumed trainer for its elastic gauges)."""
    _write_marker(run_dir, "state.json", payload)


def read_agent_state(run_dir: str) -> Optional[dict]:
    try:
        with open(_marker_path(run_dir, "state.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def write_mesh(run_dir: str, mesh: Dict[str, int]) -> None:
    """Trainer (coordinator): persist this incarnation's mesh shape so
    the NEXT incarnation's ``recovered`` record can report
    ``old_mesh`` -> ``new_mesh`` across the re-mesh."""
    _write_marker(run_dir, "mesh.json", dict(mesh))


def read_mesh(run_dir: str) -> Optional[Dict[str, int]]:
    try:
        with open(_marker_path(run_dir, "mesh.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def agent_host() -> str:
    """This process's elastic host identity (the agent exports it);
    hostname when not under an agent."""
    return os.environ.get("TPUNET_ELASTIC_HOST", socket.gethostname())


def agent_env() -> Optional[dict]:
    """The elastic environment the agent exports to its child, parsed
    from this process's env (None when not running under an agent):
    ``{"generation": int, "world": int, "rank": int}``."""
    gen = os.environ.get("TPUNET_ELASTIC_GENERATION")
    if gen is None:
        return None
    try:
        return {"generation": int(gen),
                "world": int(os.environ.get("TPUNET_ELASTIC_WORLD", "1")),
                "rank": int(os.environ.get("TPUNET_ELASTIC_RANK", "0"))}
    except ValueError:
        return None
