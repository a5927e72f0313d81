"""Fault-tolerant training end to end on the CPU: ``python -m
tpunet_torch.train --preset distributed`` children under the port's
elastic agents (threads of the test), gloo groups, MobileNetV2 at width
0.5 and 32 px, 8 rows a rank, ``--chaos`` injections; tpunet's
acceptance scenarios (tests/test_elastic.py and scripts/chaos_smoke.py):

- shrink: host 1 is SIGKILLed mid-epoch 2; the survivor re-meshes data
  2 -> 1, restores the epoch-1 checkpoint and finishes, one ``run_id``
  and one ``metrics.jsonl`` across generations;
- torn write: two transient IO errors on the first save (retried, one
  alert), then a SIGKILL with the epoch-2 write in flight; the restart
  restores the previous intact checkpoint and never reads the ``.part``;
- straggler eviction: a slow host trips the watchdog's stall detector,
  the pod checkpoints at one step and evicts one host, which leaves
  cleanly; the survivor finishes at world 1.

Each gang has its own deadline from its start; the children's logs stay
under ``tmp_path`` and go into a failure's message."""

import glob
import json
import os
import sys
import threading
import time

import pytest
import _torch_threads  # noqa: E402,F401

from tpunet_torch.elastic import chaos as chaos_mod
from tpunet_torch.elastic import events
from tpunet_torch.elastic.agent import (EXIT_DONE, EXIT_RESTARTS,
                                        AgentConfig, ElasticAgent)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos_mod.clear()


def _train_cmd(run_dir, spec, *, batch=8, synthetic=64, epochs=3, extra=()):
    return [sys.executable, "-m", "tpunet_torch.train", "--preset",
            "distributed", "--device", "cpu", "--dataset", "synthetic",
            "--synthetic-size", str(synthetic), "--image-size", "32",
            "--width-mult", "0.5", "--dtype", "float32", "--batch-size",
            str(batch), "--epochs", str(epochs), "--no-download",
            "--no-native-loader",
            "--checkpoint-dir", run_dir, "--chaos", spec, *extra]


def _logs(run_dir) -> str:
    out = []
    for path in sorted(glob.glob(os.path.join(run_dir, "elastic", "logs",
                                              "*.log"))):
        with open(path, errors="replace") as f:
            out.append(f"--- {os.path.basename(path)}\n{f.read()[-3000:]}")
    return "\n".join(out)


def _run_gang(tmp_path, cmd, hosts, env=None):
    """One agent a host, each a thread; their exit codes. Fails with the
    children's logs when the gang misses its deadline."""
    run_dir = str(tmp_path / "run")
    env = _torch_threads.child_env({}, PYTHONPATH=ROOT, **(env or {}))
    rcs = {}
    threads = []
    for host, kw in hosts.items():
        cfg = AgentConfig(run_dir=run_dir, rdzv_dir=str(tmp_path / "rdzv"),
                          host_id=host, command=cmd, settle_s=0.4,
                          timeout_s=120.0, beat_s=0.1, dead_after_s=10.0,
                          grace_s=3.0, env=env, **kw)
        t = threading.Thread(target=lambda h=host, c=cfg: rcs.__setitem__(
            h, ElasticAgent(c).run()), name=f"agent-{host}", daemon=True)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + GANG_TIMEOUT_S
    for t in threads:
        t.join(timeout=max(1.0, deadline - time.monotonic()))
        assert not t.is_alive(), \
            f"elastic gang missed its deadline:\n{_logs(run_dir)}"
    return rcs, run_dir


def _read(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(run_dir, "run_id")) as f:
        run_id = f.read().strip()
    return records, run_id


def _elastic(records, event):
    return [r for r in records
            if r.get("kind") == "obs_elastic" and r["event"] == event]


def _plain_epochs(records):
    return [r["epoch"] for r in records
            if "kind" not in r and "epoch" in r and not r.get("partial")]


def _one_stream(records, run_id):
    assert run_id
    stamped = [r for r in records if "run_id" in r]
    assert stamped and {r["run_id"] for r in stamped} == {run_id}


def test_shrink_on_sigkill_mid_epoch(tmp_path):
    run_dir = str(tmp_path / "run")
    # 4 steps an epoch at world 2: step 5 is epoch 2's second step. The
    # slow step 4 (both hosts) lets the epoch-1 save commit first; gen=0
    # keeps the faults out of the resumed incarnation.
    cmd = _train_cmd(run_dir,
                     "slow@step=4:delay=1:gen=0;kill@step=5:host=1:gen=0")
    rcs, run_dir = _run_gang(tmp_path, cmd, {"h0": {"max_restarts": 2},
                                             "h1": {"max_restarts": 0}})
    logs = _logs(run_dir)
    assert rcs == {"h0": EXIT_DONE, "h1": EXIT_RESTARTS}, logs
    assert events.is_done(run_dir), logs
    records, run_id = _read(run_dir)
    _one_stream(records, run_id)
    (shrink,) = _elastic(records, "shrink")
    assert (shrink["old_world"], shrink["new_world"]) == (2, 1)
    assert shrink["lost"] == ["h1"] and shrink["hosts"] == ["h0"]
    assert shrink["recovery_s"] > 0 and shrink["step"] == 1
    (rec,) = _elastic(records, "recovered")
    assert rec["epoch"] == 2 and rec["step"] == 4
    assert rec["old_mesh"]["data"] == 2 and rec["new_mesh"]["data"] == 1
    assert rec["generation"] == shrink["generation"] >= 1
    assert set(_plain_epochs(records)) == {1, 2, 3}
    assert max(_plain_epochs(records)) == 3
    (report,) = glob.glob(os.path.join(run_dir, "flightrec",
                                       "crash_report.p1*"))
    with open(report) as f:
        report = json.load(f)
    assert report["cause"] == "died-without-fatal-signal"    # SIGKILL
    assert any(e["kind"] == "chaos" and "SIGKILL injected (step=5)"
               in e["msg"] for e in report["events"])
    assert "Resumed from epoch 1" in logs


def test_torn_write_and_io_retry_restore_the_previous_checkpoint(tmp_path):
    run_dir = str(tmp_path / "run")
    # World 1, 16 rows a step: 4 steps an epoch. The first save's first
    # two attempts fail (retried); the second save's write is killed in
    # flight; the slow epoch 3 keeps the loop busy until it lands.
    cmd = _train_cmd(run_dir, "ioerr@save=1:fails=2:gen=0;kill@ckpt=2:gen=0;"
                              "slow@step=8:delay=1:steps=4:gen=0",
                     batch=16)
    rcs, run_dir = _run_gang(tmp_path, cmd, {"h0": {"max_restarts": 1}})
    logs = _logs(run_dir)
    assert rcs == {"h0": EXIT_DONE}, logs
    assert events.is_done(run_dir), logs
    records, run_id = _read(run_dir)
    _one_stream(records, run_id)
    (restart,) = _elastic(records, "restart")
    assert restart["cause"] == "failed"
    (rec,) = _elastic(records, "recovered")
    assert rec["epoch"] == 2
    # gen 0 logged epochs 1 and 2 (epoch 2's row lands before its save),
    # gen 1 re-ran 2 and finished 3.
    assert sorted(_plain_epochs(records)) == [1, 2, 2, 3]
    alerts = [r for r in records if r.get("kind") == "obs_alert"
              and r.get("reason") == "ckpt_io_retry"]
    assert len(alerts) == 1 and alerts[0]["what"] == "save"
    (crash,) = [r for r in records if r.get("kind") == "obs_crash"]
    with open(crash["report_path"]) as f:
        ring = json.load(f)["events"]
    retries = [e["msg"] for e in ring if e["kind"] == "ckpt"
               and e["msg"].startswith("io retry save")]
    assert retries == ["io retry save attempt=1", "io retry save attempt=2"]
    assert any("SIGKILL injected (ckpt=2)" in e["msg"] for e in ring)
    torn = glob.glob(os.path.join(run_dir, "state.pt.*.part"))
    assert len(torn) == 1, os.listdir(run_dir)
    assert "Resumed from epoch 1 " in logs


def test_straggler_eviction_checkpoints_and_shrinks(tmp_path):
    run_dir = str(tmp_path / "run")
    # 8 steps an epoch at world 2; host 1 sleeps 6 s in steps 10 and 11
    # (epoch 2). The stall threshold (3x the median step, at least 1 s)
    # is far above a step here, even one under the suite's load (about
    # 1 s), so only the injected delay trips it; the ranks agree every 2
    # steps.
    cmd = _train_cmd(run_dir, "slow@step=10:delay=6:steps=2:host=1:gen=0",
                     synthetic=128,
                     extra=("--evict-on-straggler", "--stall-factor", "3",
                            "--stall-min-s", "1.0"))
    rcs, run_dir = _run_gang(tmp_path, cmd, {"h0": {"max_restarts": 2},
                                             "h1": {"max_restarts": 2}},
                             env={"TPUNET_STOP_POLL_STEPS": "2"})
    logs = _logs(run_dir)
    # The evicted host leaves cleanly, the survivor finishes.
    assert rcs == {"h0": EXIT_DONE, "h1": EXIT_DONE}, logs
    assert events.is_done(run_dir), logs
    records, run_id = _read(run_dir)
    _one_stream(records, run_id)
    # Exactly one host leaves: first claim wins (in lockstep data
    # parallelism the straggler slows every rank's lap, docs/elasticity.md
    # "Proactive checkpoint-and-evict").
    (evict,) = _elastic(records, "evict")
    assert evict["cause"] == "step_stall" and evict["lost"] in (["h0"],
                                                                ["h1"])
    assert evict["detail"]["reason"] == "step_stall"
    (shrink,) = _elastic(records, "shrink")
    assert shrink["cause"] == "evict" and shrink["new_world"] == 1
    assert shrink["lost"] == evict["lost"]
    # Both ranks stopped at one step and saved it, marked partial (rank
    # 0 writes the records: its evict_requested breadcrumb is there when
    # its own watchdog fired too).
    partial = [r for r in records if "kind" not in r and r.get("partial")]
    assert len(partial) == 1 and partial[0]["epoch"] == 2
    for r in _elastic(records, "evict_requested"):
        assert r["step"] == partial[0]["step"]
    (rec,) = _elastic(records, "recovered")
    assert rec["epoch"] == 2 and rec["step"] == partial[0]["step"]
    assert rec["new_mesh"]["data"] == 1
    assert max(_plain_epochs(records)) == 3
    assert "Resumed from epoch 2 (partial)" in logs
