"""Start and wait for a gang of ``tests/_torch_shard_worker.py`` ranks:
gloo process groups on the CPU, each rank a subprocess with one intra-op
thread, its stdout and stderr in files beside the results, killed with
the others on any failure or timeout.

A gang's deadline is counted from its start, ``TIMEOUT_S`` for each of
its cases: under the whole suite's load (six xdist workers, other
tests' gangs, a parent running JAX meanwhile) one case can take minutes,
and a bound for the whole gang would fail a long gang that is merely
slow. Each rank is still given at least ``TIMEOUT_S`` from when the
parent starts to wait for it, however long the parent's own work took
before. Several gangs may share a directory when each has its own ``tag``
(its store file and its logs carry it)."""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from _torch_threads import child_env

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_shard_worker.py"
TIMEOUT_S = 240


@dataclass
class Gang:
    """The ranks of one gang: ``(rank, process, stdout, stderr)`` each,
    the log files' stem and the gang's deadline (``time.monotonic``)."""

    stem: str
    deadline: float
    procs: list = field(default_factory=list)


def start(d: Path, world: int, cases, tag: str = "") -> Gang:
    """The ``world`` ranks of a gang that runs ``cases`` in ``d``."""
    env = {k: v for k, v in child_env(
        PYTHONPATH=str(ROOT), TPUNET_GANG_TAG=tag).items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    gang = Gang(f"w{world}{tag}",
                time.monotonic() + TIMEOUT_S * max(1, len(cases)))
    for r in range(world):
        out = open(d / f"{gang.stem}_rank{r}.out", "w")
        err = open(d / f"{gang.stem}_rank{r}.err", "w")
        gang.procs.append((r, subprocess.Popen(
            [sys.executable, str(WORKER), str(d), str(world), str(r),
             *cases], stdout=out, stderr=err, env=env, cwd=ROOT), out, err))
    return gang


def wait(d: Path, world: int, gang: Gang) -> None:
    """Wait for every rank (each until the gang's deadline, or for
    TIMEOUT_S if that is later); raise with the failing rank's stderr,
    all of them killed, on a failure."""
    try:
        for r, p, _, _ in gang.procs:
            try:
                p.wait(timeout=max(TIMEOUT_S,
                                   gang.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"rank {r} of {world} ({gang.stem}) did not finish "
                    f"by its deadline") from None
            assert p.returncode == 0, (
                f"rank {r} of {world} exited {p.returncode}:\n"
                f"{(d / f'{gang.stem}_rank{r}.err').read_text()[-4000:]}")
    finally:
        for _, p, out, err in gang.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
