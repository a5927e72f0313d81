"""Start and wait for a gang of ``tests/_torch_shard_worker.py`` ranks:
gloo process groups on the CPU, each rank a subprocess with one intra-op
thread, its stdout and stderr in files beside the results, killed with
the others on any failure or timeout."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from _torch_threads import child_env

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_shard_worker.py"
TIMEOUT_S = 240


def start(d: Path, world: int, cases) -> list:
    """The ``world`` ranks of a gang that runs ``cases`` in ``d``."""
    env = {k: v for k, v in child_env(
        PYTHONPATH=str(ROOT)).items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for r in range(world):
        out = open(d / f"w{world}_rank{r}.out", "w")
        err = open(d / f"w{world}_rank{r}.err", "w")
        procs.append((r, subprocess.Popen(
            [sys.executable, str(WORKER), str(d), str(world), str(r),
             *cases], stdout=out, stderr=err, env=env, cwd=ROOT), out, err))
    return procs


def wait(d: Path, world: int, procs) -> None:
    """Wait for every rank (each within TIMEOUT_S); raise with the failing
    rank's stderr, all of them killed, on a failure."""
    try:
        for r, p, _, _ in procs:
            try:
                p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} of {world} did not finish "
                                     f"in {TIMEOUT_S} s") from None
            assert p.returncode == 0, (
                f"rank {r} of {world} exited {p.returncode}:\n"
                f"{(d / f'w{world}_rank{r}.err').read_text()[-4000:]}")
    finally:
        for _, p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
