"""The port's Trainer with observability on, against tpunet's, on the CPU.

- One tiny MobileNetV2 epoch and one tiny LM epoch in each package with
  ``--obs-step-every 2``: equal ``obs_epoch`` key sets (less ``mfu``:
  the CPU has no peak), equal ``steps``, the unit, ``obs_step`` records
  at the same steps; ``--no-obs`` writes no ``obs_*`` record.
- Every kind and top-level field the port emits is documented in
  docs/metrics_schema.md (``scripts/check_metrics_schema.py``), and
  tpunet's ``scripts/obs_report.py`` renders a port run directory.
- The profile window, as tests/test_observability.py holds tpunet's: a
  counting ``sync`` is called 0 times on the default path and 2 times
  for a window [1, 3); the trace holds only the window's steps; a window
  ending at the epoch's edge closes there; one outside the run creates
  nothing.
- The CLI: a fatal alert under --halt-on-unhealthy prints ``ABORT``,
  returns 2 and still closes the run (the window's trace is written);
  ``--resume`` keeps the run id.
"""

import contextlib
import io
import json
import os
import sys

import pytest

import tpunet.config as jcfg
from tpunet.train.loop import Trainer as JaxTrainer
from tpunet_torch import config as pcfg
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.loop import Trainer
import _torch_threads  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import check_metrics_schema  # noqa: E402
import obs_report  # noqa: E402

MNV2 = dict(model=dict(width_mult=0.5, dtype="float32", dropout_rate=0.0),
            data=dict(dataset="synthetic", image_size=32, batch_size=16,
                      synthetic_train_size=64, synthetic_test_size=16))
LM = dict(model=dict(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2,
                     vocab_size=32, max_seq_len=32, dropout_rate=0.0,
                     dtype="float32"),
          data=dict(dataset="synthetic_lm", batch_size=16, seq_len=32,
                    vocab_size=32, synthetic_train_size=64,
                    synthetic_test_size=16))
FAMILIES = {"mobilenet_v2": MNV2, "lm": LM}


def _records(directory) -> list:
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _port_cfg(family, directory, **obs):
    spec = FAMILIES[family]
    return pcfg.TrainConfig(
        epochs=1, data=pcfg.DataConfig(**spec["data"]),
        model=pcfg.ModelConfig(**spec["model"]),
        checkpoint=pcfg.CheckpointConfig(directory=str(directory)),
        obs=pcfg.ObsConfig(**obs))


def _run_port(cfg):
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.train()
    finally:
        trainer.close()
    return trainer


@pytest.fixture(scope="module", params=list(FAMILIES))
def both(request, tmp_path_factory):
    """(family, tpunet's records, the port's records, the port's run
    directory) of one epoch with obs_step records every 2 steps."""
    family = request.param
    spec = FAMILIES[family]
    jdir = tmp_path_factory.mktemp(f"jax_{family}")
    pdir = tmp_path_factory.mktemp(f"port_{family}")
    jt = JaxTrainer(jcfg.TrainConfig(
        epochs=1, data=jcfg.DataConfig(**spec["data"]),
        model=jcfg.ModelConfig(**spec["model"]), mesh=jcfg.MeshConfig(),
        checkpoint=jcfg.CheckpointConfig(directory=str(jdir)),
        obs=jcfg.ObsConfig(step_records_every=2, flightrec=False)))
    try:
        jt.train()
    finally:
        jt.close()
    _run_port(_port_cfg(family, pdir, step_records_every=2, flightrec=False))
    return family, _records(jdir), _records(pdir), pdir


def _kind(records, kind):
    return [r for r in records if r.get("kind") == kind]


def test_obs_epoch_keys_equal_tpunets(both):
    family, jrec, prec, _ = both
    (je,), (pe,) = _kind(jrec, "obs_epoch"), _kind(prec, "obs_epoch")
    assert set(pe) - {"mfu"} == set(je) - {"mfu"}
    assert "mfu" not in pe             # the CPU has no peak
    assert pe["steps"] == je["steps"] == 4
    assert pe["unit"] == je["unit"] == ("tokens" if family == "lm"
                                        else "examples")
    assert len(pe["step_time_sample"]) == 4
    assert pe["device_memory"] == [{"device": 0}]
    assert pe["ckpt_saves"] == 1 and pe["live_processes"] == 1
    # The plain record keeps its fields and gains the identity and the
    # config fingerprint, as tpunet's.
    (jp,), (pp,) = [[r for r in recs if "kind" not in r]
                    for recs in (jrec, prec)]
    assert set(pp) == set(jp)
    assert pp["run_id"] == pe["run_id"] and \
        pp["config_fingerprint"] == pe["config_fingerprint"]


def test_obs_step_at_the_same_steps(both):
    _, jrec, prec, _ = both
    steps = [r["step"] for r in _kind(prec, "obs_step")]
    assert steps == [r["step"] for r in _kind(jrec, "obs_step")] == [0, 2]
    assert all(set(r) == set(j) for r, j in zip(_kind(prec, "obs_step"),
                                                _kind(jrec, "obs_step")))


def test_every_record_is_documented(both):
    _, _, prec, _ = both
    kinds, fields, global_fields = check_metrics_schema.parse_schema()
    assert check_metrics_schema.undocumented(prec, kinds, fields,
                                             global_fields) == []


def test_obs_report_renders_a_port_run(both, capsys):
    _, _, _, pdir = both
    assert obs_report.main([str(pdir)]) == 0
    out = capsys.readouterr().out
    assert "step" in out and "stall" in out
    assert obs_report.main([str(pdir), "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["totals"]["obs_epochs"] == 1


def test_no_obs_writes_no_obs_record(tmp_path):
    _run_port(_port_cfg("mobilenet_v2", tmp_path, enabled=False))
    records = _records(tmp_path)
    assert len(records) == 1 and "kind" not in records[0]
    assert "run_id" not in records[0]       # tpunet's: no identity either


# ---------------------------------------------------------------------------
# The profile window
# ---------------------------------------------------------------------------

class _CountingSync:
    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1


def _window_trainer(tmp_path, start, num):
    cfg = _port_cfg("mobilenet_v2", tmp_path / "ck", flightrec=False,
                    profile_start_step=start, profile_num_steps=num)
    trainer = Trainer(cfg.replace(profile_dir=str(tmp_path / "trace")),
                      device="cpu")
    trainer._sync = _CountingSync()
    return trainer


def _train_regions(trace_dir) -> list:
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == "train"
            and e.get("cat") == "user_annotation"]


def test_default_path_never_syncs(tmp_path):
    trainer = Trainer(_port_cfg("mobilenet_v2", tmp_path, flightrec=False),
                      device="cpu")
    trainer._sync = _CountingSync()
    try:
        trainer.train()
    finally:
        trainer.close()
    assert trainer._sync.calls == 0
    assert _kind(_records(tmp_path), "obs_epoch")


def test_window_syncs_at_its_two_edges_and_traces_only_its_steps(tmp_path):
    trainer = _window_trainer(tmp_path, 1, 2)
    try:
        trainer.train_one_epoch(1)       # 4 steps; the window is [1, 3)
        assert not trainer.obs.profiler.running
        assert trainer._sync.calls == 2
    finally:
        trainer.close()
    assert trainer._sync.calls == 2
    assert len(_train_regions(tmp_path / "trace")) == 2


def test_window_ending_at_the_epoch_edge_closes_there(tmp_path):
    trainer = _window_trainer(tmp_path, 2, 2)
    try:
        trainer.train_one_epoch(1)       # 4 steps; the window is [2, 4)
        assert not trainer.obs.profiler.running
        assert trainer._sync.calls == 2
    finally:
        trainer.close()
    assert len(_train_regions(tmp_path / "trace")) == 2


def test_window_outside_the_run_creates_nothing(tmp_path):
    trainer = _window_trainer(tmp_path, 100, 2)
    try:
        trainer.train_one_epoch(1)
    finally:
        trainer.close()
    assert trainer._sync.calls == 0
    assert not (tmp_path / "trace").exists()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CLI = ["--preset", "serial", "--dataset", "synthetic", "--synthetic-size",
       "256", "--image-size", "32", "--width-mult", "0.5", "--dtype",
       "float32", "--batch-size", "16", "--device", "cpu", "--no-flightrec"]


def test_cli_halt_on_unhealthy_aborts_with_2_and_closes(tmp_path):
    """A step_stall alert (any step above 1e-9 x the median) under
    --halt-on-unhealthy: the record lands first, the CLI prints ABORT and
    returns 2, and close() still writes the open window's trace."""
    ck = tmp_path / "ck"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(CLI + ["--epochs", "1", "--checkpoint-dir", str(ck),
                             "--halt-on-unhealthy", "--stall-factor",
                             "1e-9", "--stall-min-s", "0",
                             "--profile-num-steps", "100"])
    assert rc == 2
    assert "ABORT: run unhealthy: step_stall" in buf.getvalue()
    alerts = _kind(_records(ck), "obs_alert")
    assert alerts[0]["reason"] == "step_stall" and \
        alerts[0]["severity"] == "fatal"
    assert len(os.listdir(ck / "profile")) == 1


def test_cli_resume_keeps_the_run_id(tmp_path):
    ck = str(tmp_path / "ck")
    assert cli.main(CLI + ["--epochs", "1", "--checkpoint-dir", ck]) == 0
    with open(os.path.join(ck, "run_id")) as f:
        rid = f.read().strip()
    assert cli.main(CLI + ["--epochs", "2", "--checkpoint-dir", ck,
                           "--resume"]) == 0
    records = _records(ck)
    assert [r["epoch"] for r in records if "kind" not in r] == [1, 2]
    assert {r["run_id"] for r in records} == {rid}
