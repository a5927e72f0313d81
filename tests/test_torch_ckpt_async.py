"""The port's asynchronous Checkpointer (tpunet_torch/ckpt.py) against
tpunet's (tpunet/ckpt/orbax_io.py): saves behind the caller, the
transient-IO retry and its alert, errors that surface at the next save
and at wait(), the bounded wait and abandon, the restore retry, the
snapshot's immunity to in-place updates, the committed-step sidecar and
rank 0's commit handshake through the store."""

import threading
import time

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: E402,F401

import tpunet_torch.ckpt as ckpt_mod
from tpunet.ckpt import Checkpointer as JaxCheckpointer
from tpunet.config import CheckpointConfig as JaxCheckpointConfig
from tpunet.config import ObsConfig as JaxObsConfig
from tpunet.elastic import chaos as jax_chaos_mod
from tpunet.obs import Observability as JaxObservability
from tpunet.obs.registry import MemorySink as JaxMemorySink
from tpunet_torch.ckpt import STATE, STATE_META, Checkpointer
from tpunet_torch.config import CheckpointConfig, ObsConfig
from tpunet_torch.elastic import chaos as chaos_mod
from tpunet_torch.obs import Observability
from tpunet_torch.obs.registry import MemorySink


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos_mod.clear()
    jax_chaos_mod.clear()


def _obs(tmp_path):
    obs = Observability(ObsConfig(flightrec=False),
                        checkpoint_dir=str(tmp_path))
    sink = MemorySink()
    obs.add_sink(sink)
    return obs, sink


def _jax_obs(tmp_path):
    obs = JaxObservability(JaxObsConfig(flightrec=False),
                           checkpoint_dir=str(tmp_path))
    sink = JaxMemorySink()
    obs.add_sink(sink)
    return obs, sink


def _alerts(sink):
    return [{k: v for k, v in r.items()
             if k not in ("time", "run_id", "host", "process_index",
                          "config_fingerprint")}
            for r in sink.records if r.get("kind") == "obs_alert"]


@pytest.fixture
def slow_save(monkeypatch):
    """torch.save that takes ``delay[0]`` seconds first."""
    delay = [0.5]
    real = torch.save

    def slow(obj, path):
        time.sleep(delay[0])
        real(obj, path)

    monkeypatch.setattr(torch, "save", slow)
    return delay


def _payload(epoch=1):
    g = torch.Generator().manual_seed(epoch)
    return {"model": {"w": torch.randn(6, 5, generator=g),
                      "b": torch.randn(5, generator=g).to(torch.bfloat16)},
            "optimizer": {"state": {0: {"exp_avg": torch.randn(4, generator=g),
                                        "step": torch.tensor(3.0)}},
                          "param_groups": [{"lr": 0.1, "params": [0]}]},
            "global_step": 4 * epoch, "epoch": epoch, "best_acc": 0.5,
            "completed": True}


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def test_a_save_overlaps_the_caller_and_restores_to_the_bit(tmp_path,
                                                           slow_save):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    payload = _payload()
    want = {k: v for k, v in payload.items()}
    want = ckpt_mod._map(lambda t: t.clone(), want)
    t0 = time.perf_counter()
    assert ck.save_state(payload) == str(tmp_path / STATE)
    assert time.perf_counter() - t0 < 0.4         # the write runs behind
    assert ck.saving_in_progress()
    # Adam's in-place update after the dispatch: the snapshot keeps the
    # values of the dispatch.
    payload["model"]["w"].add_(1.0)
    payload["optimizer"]["state"][0]["exp_avg"].mul_(0.0)
    assert not (tmp_path / STATE).exists()
    assert ck.wait() is True
    assert not ck.saving_in_progress()
    restored = Checkpointer(CheckpointConfig(
        directory=str(tmp_path))).restore_state()
    assert _equal(restored, want)
    assert ck.latest_step() == 1
    ck.close()


def test_transient_save_error_retried_with_one_alert_as_tpunets(tmp_path):
    obs, sink = _obs(tmp_path / "port")
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / "port")),
                      obs=obs)
    chaos_mod._CURRENT = chaos_mod.Chaos.parse("ioerr@save=1:fails=2")
    try:
        ck.save_state(_payload())
        assert ck.wait() is True
    finally:
        ck.close()
        obs.close()
    jobs, jsink = _jax_obs(tmp_path / "ref")
    jck = JaxCheckpointer(JaxCheckpointConfig(
        directory=str(tmp_path / "ref")), obs=jobs)
    jax_chaos_mod._CURRENT = jax_chaos_mod.Chaos.parse("ioerr@save=1:fails=2")
    try:
        jck.save_state(1, {"x": np.arange(8, dtype=np.int32)})
        assert jck.wait() is True
    finally:
        jck.close()
        jobs.close()
    for name in ("ckpt_io_retries", "ckpt_saves", "obs_alerts"):
        assert obs.registry.counter(name).value == \
            jobs.registry.counter(name).value, name
    assert obs.registry.counter("ckpt_io_retries").value == 2
    assert _alerts(sink) == _alerts(jsink)
    (alert,) = _alerts(sink)
    assert alert["reason"] == "ckpt_io_retry" and alert["what"] == "save"
    restored = Checkpointer(CheckpointConfig(
        directory=str(tmp_path / "port"))).restore_state()
    assert _equal(restored, _payload())


def test_exhausted_retries_raise_at_the_next_save_and_at_wait(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.IO_BACKOFF_S = 0.01
    chaos_mod._CURRENT = chaos_mod.Chaos.parse("ioerr@save=1:fails=9")
    ck.save_state(_payload())
    while ck.saving_in_progress():
        time.sleep(0.01)
    with pytest.raises(OSError, match="chaos: injected transient save"):
        ck.save_state(_payload(2))
    with pytest.raises(OSError, match="chaos"):
        ck.wait()
    assert ck.wait() is True                     # raised once, at the join
    ck.close()
    assert not (tmp_path / STATE).exists()
    # Without a later save or wait, close() raises it.
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.IO_BACKOFF_S = 0.01
    chaos_mod._CURRENT = chaos_mod.Chaos.parse("ioerr@save=1:fails=9")
    ck.save_state(_payload())
    with pytest.raises(OSError, match="chaos"):
        ck.close()
    assert not (tmp_path / STATE).exists()


def test_a_non_transient_error_is_not_retried(tmp_path, monkeypatch):
    obs, sink = _obs(tmp_path)
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)), obs=obs)

    def corrupt(obj, path):
        raise RuntimeError("not transient")

    monkeypatch.setattr(torch, "save", corrupt)
    ck.save_state(_payload())
    with pytest.raises(RuntimeError, match="not transient"):
        ck.wait()
    assert obs.registry.counter("ckpt_io_retries").value == 0
    assert _alerts(sink) == []
    assert not list(tmp_path.glob("*.part"))
    ck.abandon()
    obs.close()


def test_transient_restore_error_retried_as_tpunets(tmp_path):
    obs, _ = _obs(tmp_path / "port")
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / "port")),
                      obs=obs)
    jobs, _ = _jax_obs(tmp_path / "ref")
    jck = JaxCheckpointer(JaxCheckpointConfig(
        directory=str(tmp_path / "ref")), obs=jobs)
    try:
        ck.save_state(_payload())
        ck.wait()
        jck.save_state(1, {"x": np.arange(4, dtype=np.int32)})
        jck.wait()
        chaos_mod._CURRENT = chaos_mod.Chaos.parse("ioerr@restore=1:fails=1")
        jax_chaos_mod._CURRENT = jax_chaos_mod.Chaos.parse(
            "ioerr@restore=1:fails=1")
        restored = ck.restore_state()
        assert jck.restore_state({"x": np.zeros(4, dtype=np.int32)}) \
            is not None
        assert _equal(restored, _payload())
        assert obs.registry.counter("ckpt_io_retries").value == \
            jobs.registry.counter("ckpt_io_retries").value == 1
    finally:
        ck.close()
        jck.close()
        obs.close()
        jobs.close()


def test_grace_timeout_goes_permanently_nonblocking(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    # Three injected failures keep the writer in backoff for ~0.7 s.
    chaos_mod._CURRENT = chaos_mod.Chaos.parse("ioerr@save=1:fails=3")
    ck.save_state(_payload())
    assert ck.wait(timeout=0.05) is False
    assert ck.abandoned
    t0 = time.monotonic()
    assert ck.wait() is False
    ck.close()
    assert ck.save_state(_payload(2)) is None
    assert time.monotonic() - t0 < 0.5
    time.sleep(1.0)
    assert not (tmp_path / STATE).exists()       # never renamed in


def test_abandon_makes_wait_and_close_nonblocking(tmp_path, slow_save):
    slow_save[0] = 1.0
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save_state(_payload())
    ck.save_best({"w": torch.ones(2)})
    ck.abandon()
    t0 = time.monotonic()
    assert ck.wait() is False
    ck.close()
    assert time.monotonic() - t0 < 0.5
    time.sleep(1.5)
    assert not (tmp_path / STATE).exists()
    assert not (tmp_path / "best.pth").exists()
    assert not list(tmp_path.glob("*.part"))


def test_back_pressure_holds_one_in_flight_and_one_queued(tmp_path,
                                                          slow_save):
    slow_save[0] = 0.3
    obs, _ = _obs(tmp_path)
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)), obs=obs)
    ck.save_state(_payload(1))
    ck.save_state(_payload(2))
    assert len(ck._pending) == 2
    assert obs.registry.counter("ckpt_wait_s").value == 0
    t0 = time.perf_counter()
    ck.save_state(_payload(3))                   # waits for the first
    waited = time.perf_counter() - t0
    assert len(ck._pending) <= 2 and waited > 0.1
    assert obs.registry.counter("ckpt_wait_s").value == pytest.approx(
        waited, abs=0.05)
    ck.wait()
    assert ck.latest_step() == 3
    assert _equal(ck.restore_state(), _payload(3))
    assert obs.registry.counter("ckpt_saves").value == 3
    ck.close()
    obs.close()


def test_latest_step_reads_the_sidecar_not_the_tensors(tmp_path,
                                                       monkeypatch):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    assert ck.latest_step() is None
    ck.save_state(_payload(2))
    ck.wait()
    (tmp_path / "state.pt.torn.part").write_bytes(b"a torn write")

    def no_load(*a, **k):
        raise AssertionError("latest_step loaded the tensors")

    monkeypatch.setattr(torch, "load", no_load)
    assert ck.latest_step() == 2
    import json
    meta = json.loads((tmp_path / STATE_META).read_text())
    assert meta == {"step": 2, "global_step": 8, "completed": True}
    ck.close()


def test_kill_in_flight_leaves_the_previous_state(tmp_path):
    """The torn-write point: the hook runs after the .part file is
    written and before its rename; a raise there (a SIGKILL in the
    chaos run) leaves state.pt and its sidecar at the previous save."""
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save_state(_payload(1))
    ck.wait()
    seen = []

    class Killed(BaseException):
        pass

    class Torn:
        def save_attempt(self, index, attempt):
            seen.append(("attempt", index, attempt))

        def save_in_flight(self, index):
            seen.append(("in_flight", index,
                         sorted(p.name for p in tmp_path.glob("*.part"))))
            raise Killed("killed mid-write")

    chaos_mod._CURRENT = Torn()
    ck.save_state(_payload(2))
    with pytest.raises(Killed):
        ck.wait()
    assert seen[0] == ("attempt", 2, 0)
    assert seen[1][:2] == ("in_flight", 2) and len(seen[1][2]) == 1
    assert seen[1][2][0].startswith("state.pt.")
    chaos_mod.clear()
    assert ck.latest_step() == 1
    assert _equal(ck.restore_state(), _payload(1))
    ck.abandon()


def test_unarmed_checkpointer_runs_no_hook(tmp_path, monkeypatch):
    called = []
    for hook in ("save_attempt", "save_in_flight", "restore_attempt"):
        monkeypatch.setattr(chaos_mod.Chaos, hook,
                            lambda *a, h=hook: called.append(h))
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save_state(_payload())
    ck.wait()
    ck.restore_state()
    ck.close()
    assert called == [] and ckpt_mod._chaos() is None


def test_best_and_its_meta_are_written_behind(tmp_path, slow_save):
    slow_save[0] = 0.3
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save_best({"w": torch.arange(3.0)}, meta={"model": "lm"})
    assert not (tmp_path / "best.pth").exists()
    assert ck.best_meta() == {"model": "lm"}      # drains first
    assert ck.best_path() == str(tmp_path / "best.pth")
    assert torch.equal(torch.load(tmp_path / "best.pth")["w"],
                       torch.arange(3.0))
    ck.close()


def _rank(monkeypatch, store, rank):
    monkeypatch.setattr(ckpt_mod.dist, "process_count", lambda: 2)
    monkeypatch.setattr(ckpt_mod, "is_coordinator", lambda: rank == 0)
    monkeypatch.setattr(torch.distributed.distributed_c10d,
                        "_get_default_store", lambda: store)


def test_other_ranks_wait_for_rank_0s_commit(tmp_path, monkeypatch,
                                             slow_save):
    """Rank 0's writer publishes each commit under a store key; rank 1
    writes nothing and waits for those keys in wait() (bounded, too),
    and raises when rank 0's save failed."""
    slow_save[0] = 0.5
    store = torch.distributed.HashStore()
    _rank(monkeypatch, store, 1)
    other = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    assert other.save_state(_payload()) == str(tmp_path / STATE)
    assert not other.saving_in_progress() and other._commits
    _rank(monkeypatch, store, 0)
    zero = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    zero.save_state(_payload())
    _rank(monkeypatch, store, 1)
    done = []
    t = threading.Thread(target=lambda: done.append(other.wait()))
    t0 = time.perf_counter()
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive() and done == [True]
    assert time.perf_counter() - t0 > 0.2        # it waited for rank 0
    assert (tmp_path / STATE).exists() and not other._commits
    zero.close()

    # A failed save on rank 0 fails rank 1's wait too.
    _rank(monkeypatch, store, 1)
    other.save_state(_payload(2))
    _rank(monkeypatch, store, 0)
    zero.IO_BACKOFF_S = 0.01
    chaos_mod._CURRENT = chaos_mod.Chaos.parse("ioerr@save=2:fails=9")
    zero.save_state(_payload(2))
    with pytest.raises(OSError):
        zero.wait()
    zero.abandon()
    _rank(monkeypatch, store, 1)
    with pytest.raises(RuntimeError, match="rank 0's checkpoint save failed"):
        other.wait()

    # A bounded wait that rank 0 never answers abandons.
    other.save_state(_payload(3))
    assert other.wait(timeout=0.1) is False and other.abandoned
