"""Run identity: the join keys that make record streams mergeable.

A copy of ``tpunet/obs/identity.py`` (framework-free).

A fleet dashboard aggregating N runs' streams (tpunet/obs/agg/) needs
to know which records belong together; nothing in a bare record says
so. Every record emitted through ``Registry.emit`` is therefore
stamped at the source with

- ``run_id``        — one logical run (stable across a preemption
  restore: ``--resume`` reads the id the original run persisted next
  to its checkpoints, so the restored stream continues the same run
  instead of appearing as a new replica);
- ``process_index`` — which process of the run (0 on single-host);
- ``host``          — the machine, for the human reading the page.

The id is persisted as ``<checkpoint_dir>/run_id`` by the coordinator
(the only process whose records leave the host — jsonl and exporters
are both coordinator-only). A fresh run into a reused directory
regenerates the id, mirroring MetricsLogger's truncate-on-fresh-run
discipline: one file, one run, one id.
"""

from __future__ import annotations

import os
import socket
import uuid

RUN_ID_FILE = "run_id"


def ensure_run_id(directory: str, resume: bool = False,
                  *, persist: bool = True) -> str:
    """Return the run's id, creating or reusing ``<directory>/run_id``.

    ``resume=True`` reuses a persisted id when one exists (the
    preemption-restore path); otherwise a fresh id is generated and —
    when ``persist`` (coordinator) — written for future restores.
    Non-coordinator processes pass ``persist=False``: on a resume they
    read the coordinator's persisted file like everyone else; on a
    fresh run they get an ephemeral id rather than racing the
    coordinator's rewrite of a possibly stale file — acceptable
    because only coordinator records ever leave the host (jsonl and
    exporters are both coordinator-only).
    """
    path = os.path.join(directory, RUN_ID_FILE) if directory else ""
    if resume and path and os.path.isfile(path):
        with open(path) as f:
            run_id = f.read().strip()
        if run_id:
            return run_id
    run_id = uuid.uuid4().hex[:12]
    if persist and path:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(run_id + "\n")
        os.replace(tmp, path)
    return run_id


def run_identity(*, run_id: str = "", directory: str = "",
                 resume: bool = False, process_index: int = 0,
                 persist: bool = True) -> dict:
    """The identity stamp for ``Registry.set_identity``: an explicit
    ``run_id`` (config/CLI) wins; otherwise one is ensured under
    ``directory`` (see ``ensure_run_id``)."""
    rid = run_id or ensure_run_id(directory, resume, persist=persist)
    return {
        "run_id": rid,
        "process_index": int(process_index),
        "host": socket.gethostname(),
    }
