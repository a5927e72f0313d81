"""The port's preemption guard and agreed stop, on the CPU (mirrors of
tests/test_preemption.py, whose Trainer tests are tpunet's).

- ``PreemptionGuard`` (a copy of tpunet's): signal capture and handler
  restore, escalation on a second signal, idempotent requests, the
  grace window's remaining budget.
- The Trainer: a preempted run saves its state marked partial with a
  ``partial: true`` record and no eval fields, and ``--resume`` re-runs
  that epoch while the step counter goes on; a second signal abandons
  the save; a save slower than the grace window is abandoned, never
  renamed into place.
- The CLI: SIGTERM after the second logged step exits 0, and
  ``--resume`` finishes the run.
- 2 gloo ranks: SIGTERM to rank 1 stops both at the same step with one
  saved state; under ``--halt-on-unhealthy`` a fatal alert on rank 1
  stops both at the same step and both exit 2.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from tpunet_torch.ckpt import Checkpointer
from tpunet_torch.config import (CheckpointConfig, DataConfig, ModelConfig,
                                 OptimConfig, TrainConfig)
from tpunet_torch.parallel.dist import agree_any
from tpunet_torch.train.loop import Trainer
from tpunet_torch.utils.preemption import PreemptionGuard

from test_torch_mixup import ROOT, run_workers
import _torch_threads  # noqa: E402,F401


def test_guard_catches_signal_and_restores_handler():
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    before = signal.getsignal(signal.SIGUSR1)
    with guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested
    assert signal.getsignal(signal.SIGUSR1) == before


def test_second_signal_escalates():
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    with guard:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested and not guard.escalated
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.escalated


def test_programmatic_request_is_idempotent_unless_escalating():
    guard = PreemptionGuard()
    guard.request()
    guard.request()
    assert guard.requested and not guard.escalated
    guard.request(escalate=True)
    assert guard.escalated


def test_deadline_remaining_budget():
    clock = [100.0]
    guard = PreemptionGuard(deadline_s=30.0, clock=lambda: clock[0])
    assert guard.remaining() is None
    guard.request()
    assert guard.remaining() == 30.0
    clock[0] += 12.5
    assert guard.remaining() == 17.5
    clock[0] += 100.0
    assert guard.remaining() == 0.0
    unbounded = PreemptionGuard()
    unbounded.request()
    assert unbounded.remaining() is None


def test_agreement_is_the_local_flag_in_a_world_of_one():
    assert agree_any("t/0", True) and not agree_any("t/1", False)


# -- the Trainer ---------------------------------------------------------------


def _cfg(tmp_path, epochs=3, resume=False, grace=0.0):
    return TrainConfig(
        epochs=epochs, preempt_grace_s=grace,
        data=DataConfig(dataset="synthetic", image_size=32, batch_size=32,
                        synthetic_train_size=64, synthetic_test_size=32),
        model=ModelConfig(name="vit", vit_patch=4, vit_hidden=32,
                          vit_depth=1, vit_heads=2, dropout_rate=0.0,
                          dtype="float32"),
        optim=OptimConfig(),
        checkpoint=CheckpointConfig(directory=str(tmp_path), resume=resume))


def _rows(tmp_path):
    path = os.path.join(str(tmp_path), "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_preempted_run_saves_state_and_resumes(tmp_path):
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    real_epoch = trainer.train_one_epoch

    def epoch_then_preempt(epoch):
        m = real_epoch(epoch)
        trainer.guard.request()   # the SIGTERM handler's path
        return m

    trainer.train_one_epoch = epoch_then_preempt
    try:
        history = trainer.train()
    finally:
        trainer.close()
    assert history == []          # the preempted epoch logs no full record
    assert trainer.global_step == 2  # 64 / 32
    all_rows = _rows(tmp_path)
    rows = [r for r in all_rows if "kind" not in r]
    obs_rows = [r for r in all_rows if r.get("kind") == "obs_epoch"]
    assert len(obs_rows) == 1 and obs_rows[0].get("partial") is True
    assert len(rows) == 1 and rows[0]["partial"] is True
    assert rows[0]["epoch"] == 1 and rows[0]["step"] == 2
    assert "test_accuracy" not in rows[0]
    assert np.isfinite(rows[0]["train_loss"])
    saved = torch.load(tmp_path / "state.pt", weights_only=True)
    assert saved["completed"] is False and saved["epoch"] == 1

    resumed = Trainer(_cfg(tmp_path, resume=True), device="cpu")
    try:
        # The cut epoch is re-run; the step counter goes on.
        assert resumed.start_epoch == 1 and resumed.global_step == 2
        history = resumed.train()
    finally:
        resumed.close()
    assert [r["epoch"] for r in history] == [1, 2, 3]
    assert resumed.global_step == 2 + 3 * 2


def test_escalated_preemption_abandons_checkpoint(tmp_path):
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    real_epoch = trainer.train_one_epoch

    def epoch_then_double_preempt(epoch):
        m = real_epoch(epoch)
        trainer.guard.request()
        trainer.guard.request(escalate=True)   # the second SIGTERM
        return m

    trainer.train_one_epoch = epoch_then_double_preempt
    t0 = time.monotonic()
    try:
        history = trainer.train()
    finally:
        trainer.close()
    assert history == [] and trainer.ckpt.abandoned
    assert not (tmp_path / "state.pt").exists()
    assert time.monotonic() - t0 < 60.0
    assert not [r for r in _rows(tmp_path) if r.get("partial")]
    assert trainer.ckpt.save_state({"x": 1}) is None   # nothing starts


def test_save_slower_than_the_grace_window_is_abandoned(tmp_path,
                                                        monkeypatch):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    real_save = torch.save

    def slow_save(obj, path):
        time.sleep(1.0)
        real_save(obj, path)

    monkeypatch.setattr(torch, "save", slow_save)
    assert ckpt.save_state({"x": torch.ones(2)}, timeout=0.05) is None
    assert ckpt.abandoned
    time.sleep(1.5)          # the write finishes, and is not renamed in
    assert not (tmp_path / "state.pt").exists()
    assert not list(tmp_path.glob("*.part"))
    fresh = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    assert fresh.save_state({"x": torch.ones(2)}, timeout=30.0) is not None
    assert (tmp_path / "state.pt").exists()


# -- the CLI and two ranks -------------------------------------------------------

CLI = ["-m", "tpunet_torch.train", "--preset", "serial", "--dataset",
       "synthetic", "--synthetic-size", "256", "--image-size", "32",
       "--batch-size", "16", "--width-mult", "0.5", "--dtype", "float32",
       "--epochs", "2", "--device", "cpu", "--no-download",
       "--log-every-steps", "1"]


def test_sigterm_to_the_cli_exits_0_and_resume_finishes(tmp_path):
    args = [sys.executable] + CLI + ["--checkpoint-dir", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("  step 2 "):
            proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=300) == 0, "".join(lines)
    out = "".join(lines)
    assert "Preemption requested at epoch 1" in out
    rows = [r for r in _rows(tmp_path) if "kind" not in r]
    assert len(rows) == 1 and rows[0]["partial"] and rows[0]["epoch"] == 1
    step = rows[0]["step"]
    assert 2 <= step < 16
    done = subprocess.run(args + ["--resume"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "Resumed from epoch 1 (partial)" in done.stdout
    rows = [r for r in _rows(tmp_path) if "kind" not in r]
    assert [r["epoch"] for r in rows[1:]] == [1, 2]
    assert rows[-1]["step"] == step + 2 * 16


def test_two_ranks_stop_at_the_same_step(tmp_path):
    ranks = run_workers(tmp_path, 2, "stop")
    assert [r["rc"] for r in ranks] == [0, 0]
    assert [r["step"] for r in ranks] == [2, 2]
    assert all(r["requested"] for r in ranks)
    assert [r["history"] for r in ranks] == [[], []]
    saved = torch.load(tmp_path / "ck_stop" / "state.pt", weights_only=True)
    assert saved["completed"] is False and saved["global_step"] == 2


def test_two_ranks_halt_on_unhealthy_at_the_same_step(tmp_path):
    ranks = run_workers(tmp_path, 2, "halt")
    assert [r["rc"] for r in ranks] == [2, 2]
    assert [r["step"] for r in ranks] == [2, 2]
    saved = torch.load(tmp_path / "ck_halt" / "state.pt", weights_only=True)
    assert saved["completed"] is False and saved["global_step"] == 2
    alerts = [r for r in _rows(tmp_path / "ck_halt")
              if r.get("kind") == "obs_alert"]
    assert alerts == [] or all(a["reason"] == "nan_loss" for a in alerts)
