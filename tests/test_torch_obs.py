"""The port's observability modules against tpunet's, on the CPU.

- ``health``: the same seeded laps, losses, heartbeats and gauge
  snapshots through tpunet's ``Watchdog`` and the port's give equal
  ``obs_alert`` lists and suppression counts (stall, NaN, spike, a
  ``GaugePredicate`` rule, the cooldown, the heartbeats).
- ``summary``, ``history.fingerprint``, ``identity``: equal outputs on
  the same inputs, and tpunet's persist/resume semantics of the run id.
- ``perf``: ``train_flops_per_unit`` equal to tpunet's for MobileNetV2
  and, each package with its own parameter count, the tiny ViT and LM;
  the H100 peak table; no MFU on the CPU.
- ``config``: ``ObsConfig``/``ExportConfig`` defaults, the CLI's obs
  flags mapped as tpunet maps them, and the refusals.
- ``export``: statsd to a local UDP socket, line-JSON to a local HTTP
  listener, a full queue that drops and counts.
"""

import dataclasses
import json
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

import tpunet.config as jcfg
import tpunet.obs.health as jhealth
import tpunet.obs.identity as jidentity
import tpunet.obs.perf as jperf
import tpunet.obs.summary as jsummary
from tpunet.config import config_from_args as jax_config_from_args
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet.models import num_params as jax_num_params
from tpunet.obs.history.fingerprint import \
    config_fingerprint as jax_config_fingerprint
from tpunet.obs.registry import MemorySink as JaxMemorySink
from tpunet.obs.registry import Registry as JaxRegistry
from tpunet_torch import config as pcfg
from tpunet_torch.models import create_model, num_params
from tpunet_torch.obs import Observability, health, identity, perf, summary
from tpunet_torch.obs.export import (AsyncExporter, HttpLineTransport,
                                     MemoryTransport, StatsdTransport,
                                     build_exporters)
from tpunet_torch.obs.history import config_fingerprint, train_fingerprint
from tpunet_torch.obs.registry import MemorySink, Registry
from tpunet_torch.train import __main__ as cli


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# health: the watchdog
# ---------------------------------------------------------------------------

def _drive_watchdog(mod, registry_cls, sink_cls, scenario):
    """One seeded scenario through ``mod.Watchdog``: its alert records
    (as emitted), its ``alerts`` list and its suppression count."""
    rng = np.random.default_rng(7)
    cfg = jcfg.ObsConfig(stall_factor=3.0, stall_min_s=0.0,
                         loss_spike_factor=4.0, heartbeat_timeout_s=10.0,
                         alert_cooldown_steps=(5 if scenario == "cooldown"
                                               else 0),
                         gauge_rules=("mem_peak > 100", "mem_peak + 5/s"))
    reg = registry_cls()
    sink = sink_cls()
    reg.add_sink(sink)
    clock = _Clock()
    dog = mod.Watchdog(cfg, reg, expected_processes=2, clock=clock)
    laps = 0.01 + 0.002 * rng.random(40)
    losses = 2.0 + 0.1 * rng.standard_normal(40)
    if scenario in ("stall", "cooldown"):
        laps[[12, 13, 14, 20, 31]] = [0.5, 0.6, 0.7, 0.9, 0.4]
    if scenario == "nan":
        losses[[9, 25]] = [float("nan"), float("inf")]
    if scenario == "spike":
        losses[[15, 33]] = [40.0, 90.0]
    for step in range(40):
        clock.t += float(laps[step])
        dog.observe_step(step, float(laps[step]))
        dog.observe_loss(step, float(losses[step]))
        if scenario == "rule" and step % 5 == 0:
            clock.t += 1.0
            dog.check_gauges(step, {"mem_peak": 60.0 + 10.0 * step})
        if scenario == "heartbeat" and step % 10 == 9:
            clock.t += 30.0
            dog.check_heartbeat(step)
            dog.observe_heartbeat(1 + step % 20 // 10, step=step)
    return (sink.by_kind("obs_alert"), dog.alerts,
            reg.counter("obs_alerts_suppressed").value)


@pytest.mark.parametrize("scenario", ["stall", "nan", "spike", "rule",
                                      "cooldown", "heartbeat"])
def test_watchdog_alerts_equal_tpunets(scenario):
    """Equal alert records (reason, step, severity, details) and equal
    suppression counts, exactly."""
    want = _drive_watchdog(jhealth, JaxRegistry, JaxMemorySink, scenario)
    got = _drive_watchdog(health, Registry, MemorySink, scenario)
    assert want[0], scenario          # the scenario does raise alerts
    assert got == want
    if scenario == "cooldown":
        assert want[2] > 0


def test_gauge_predicate_parses_as_tpunets():
    for spec in ("mfu < 0.3", "step_time_s_p99 > 2", "x + 1e6/s"):
        a = jhealth.GaugePredicate.parse(spec)
        b = health.GaugePredicate.parse(spec)
        assert (a.name, a.above, a.below, a.grow_per_s, a.spec) == \
            (b.name, b.above, b.below, b.grow_per_s, b.spec)
    for bad in ("mfu", "mfu >", "mfu ~ 3"):
        with pytest.raises(ValueError):
            health.GaugePredicate.parse(bad)


# ---------------------------------------------------------------------------
# summary, fingerprint, identity
# ---------------------------------------------------------------------------

def _records(seed):
    rng = np.random.default_rng(seed)
    out = []
    step = 0
    for epoch in range(1, 4):
        for _ in range(6):
            out.append({"kind": "obs_step", "step": step,
                        "step_time_s": float(rng.random()),
                        "data_wait_s": float(rng.random() * 0.1)})
            step += 1
        out.append({"epoch": epoch, "seconds": float(rng.random() * 9),
                    "examples_per_sec": float(rng.random() * 1e3)})
        out.append({"kind": "obs_epoch", "epoch": epoch, "step": step,
                    "train_seconds": float(rng.random() * 8),
                    "input_stall_s": float(rng.random()),
                    "examples_per_sec": float(rng.random() * 1e3),
                    "mfu": float(rng.random()), "live_processes": 1,
                    "device_memory": [{"device": 0,
                                       "peak_bytes_in_use":
                                           int(rng.integers(1, 1e9))}]})
    out.append({"kind": "obs_alert", "reason": "step_stall", "step": 4,
                "severity": "fatal"})
    out.append({"kind": "obs_crash", "cause": "signal", "step": 9})
    return out


def test_summarize_equals_tpunets():
    records = _records(3)
    got = summary.summarize(records, n_windows=4)
    assert got == jsummary.summarize(records, n_windows=4)
    assert got["totals"]["obs_epochs"] == 3 and got["totals"]["crashes"] == 1


def test_config_fingerprint_equals_tpunets():
    value = {"model": {"name": "lm", "width": 0.5, "dims": (8, 16)},
             "data": [1, 2.5, "x", None], "epochs": 3}
    assert config_fingerprint(value) == jax_config_fingerprint(value)
    assert len(config_fingerprint(value)) == 12


def test_train_fingerprint_hashes_compute_fields_only():
    base = pcfg.TrainConfig()
    fp = train_fingerprint(base)
    assert fp == config_fingerprint({
        "model": dataclasses.asdict(base.model),
        "data": dataclasses.asdict(base.data),
        "optim": dataclasses.asdict(base.optim), "mesh": {},
        "epochs": base.epochs})
    assert train_fingerprint(base.replace(
        obs=pcfg.ObsConfig(step_records_every=3), profile_dir="x")) == fp
    assert train_fingerprint(base.replace(epochs=3)) != fp


@pytest.mark.parametrize("mod", [jidentity, identity],
                         ids=["tpunet", "port"])
def test_run_identity_persists_and_resumes(tmp_path, mod):
    """A fresh run persists its id; --resume reuses it; a fresh run into
    the same directory regenerates it; persist=False writes nothing;
    an explicit id wins."""
    d = str(tmp_path)
    first = mod.run_identity(directory=d)
    assert (tmp_path / "run_id").read_text().strip() == first["run_id"]
    assert first["process_index"] == 0 and first["host"] == \
        socket.gethostname()
    assert mod.run_identity(directory=d, resume=True)["run_id"] == \
        first["run_id"]
    fresh = mod.run_identity(directory=d)["run_id"]
    assert fresh != first["run_id"]
    other = tmp_path / "other"
    mod.ensure_run_id(str(other), persist=False)
    assert not other.exists()
    assert mod.run_identity(run_id="explicit", directory=d,
                            process_index=3) == {
        "run_id": "explicit", "process_index": 3,
        "host": socket.gethostname()}
    assert (tmp_path / "run_id").read_text().strip() == fresh


# ---------------------------------------------------------------------------
# perf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,size", [(0.5, 32), (1.0, 32), (0.5, 224),
                                        (1.0, 224)])
def test_mobilenetv2_train_flops_equal_tpunets(width, size):
    want = jperf.train_flops_per_unit(jcfg.ModelConfig(width_mult=width),
                                      jcfg.DataConfig(image_size=size))
    got = perf.train_flops_per_unit(pcfg.ModelConfig(width_mult=width),
                                    pcfg.DataConfig(image_size=size))
    assert got == want > 0


VIT = dict(name="vit", vit_patch=4, vit_hidden=32, vit_depth=2, vit_heads=2)
LM = dict(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2, vocab_size=64,
          max_seq_len=64)


@pytest.mark.parametrize("family", ["vit", "lm"])
def test_transformer_train_flops_equal_tpunets(family):
    """Each package counts its own parameters of the same tiny config
    (the counts are equal); the FLOPs a unit are then equal."""
    fields = VIT if family == "vit" else LM
    jdata = jcfg.DataConfig(image_size=32, seq_len=32, vocab_size=64,
                            dataset="synthetic_lm" if family == "lm"
                            else "synthetic")
    pdata = pcfg.DataConfig(image_size=32, seq_len=32, vocab_size=64,
                            dataset=jdata.dataset)
    jmodel = jax_create_model(jcfg.ModelConfig(**fields))
    shapes = jax.eval_shape(lambda k: init_variables(jmodel, k,
                                                     image_size=32),
                            jax.random.PRNGKey(0))
    jn = jax_num_params(shapes["params"])
    pn = num_params(create_model(pcfg.ModelConfig(**fields), device="cpu",
                                 image_size=32))
    assert pn == jn
    want = jperf.train_flops_per_unit(jcfg.ModelConfig(**fields), jdata,
                                      n_params=jn)
    assert perf.train_flops_per_unit(pcfg.ModelConfig(**fields), pdata,
                                     n_params=pn) == want > 0


def test_device_peak_flops_table(monkeypatch):
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA H100 PCIe",
             2: "NVIDIA H100 NVL", 3: "Tesla V100-SXM2-16GB"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: names[
        torch.device(d).index])
    assert perf.device_peak_flops(torch.device("cuda", 0)) == 989e12
    assert perf.device_peak_flops("cuda:1") == 756e12
    assert perf.device_peak_flops(2) == 835e12
    assert perf.device_peak_flops("cuda:3") is None
    assert perf.device_peak_flops("cpu") is None


def test_no_mfu_on_the_cpu(tmp_path):
    """A CPU device has no peak: ``mfu`` is None and the obs_epoch record
    has no ``mfu`` key, as tpunet's on its CPU backend."""
    assert perf.mfu(1000.0, 1e9, device="cpu") is None
    assert jperf.mfu(1000.0, 1e9) is None
    obs = Observability(pcfg.ObsConfig(flightrec=False),
                        checkpoint_dir=str(tmp_path), device="cpu")
    obs.set_flops_per_unit(1e9)
    obs.begin_epoch(1)
    obs.observe_step(0, 0.01)
    rec = obs.end_epoch(epoch=1, step=1, units=100.0, train_seconds=0.1)
    obs.close()
    assert "mfu" not in rec and obs.registry.gauge("mfu").value is None
    assert rec["device_memory"] == [{"device": 0}]
    assert rec["live_processes"] == 1


# ---------------------------------------------------------------------------
# config and CLI
# ---------------------------------------------------------------------------

def test_obs_and_export_defaults_equal_tpunets():
    assert dataclasses.asdict(pcfg.ObsConfig()) == \
        dataclasses.asdict(jcfg.ObsConfig())
    assert dataclasses.asdict(pcfg.ExportConfig()) == \
        dataclasses.asdict(jcfg.ExportConfig())
    assert [f.name for f in dataclasses.fields(pcfg.ObsConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.ObsConfig)]


OBS_FLAGS = [
    ["--no-obs"],
    ["--obs-step-every", "3", "--obs-hist-samples", "99", "--run-id", "r7",
     "--no-flightrec", "--flightrec-events", "64"],
    ["--profile-dir", "/tmp/p", "--profile-start-step", "5",
     "--profile-num-steps", "2"],
    ["--statsd", "h:1", "--obs-http", "http://h/", "--obs-webhook",
     "http://w/", "--obs-queue-size", "7"],
    ["--halt-on-unhealthy", "--stall-factor", "4", "--stall-min-s", "0.5",
     "--loss-spike-factor", "6", "--heartbeat-timeout", "30",
     "--alert-cooldown-steps", "9", "--obs-rule", "mfu < 0.3",
     "--obs-rule", "x + 1/s"],
    ["--flightrec", "--profile-start-step", "3"],
]


@pytest.mark.parametrize("flags", OBS_FLAGS, ids=lambda f: f[0])
def test_cli_obs_flags_map_as_tpunets(flags):
    want = jax_config_from_args(flags)
    got, _ = cli.config_from_args(flags)
    assert dataclasses.asdict(got.obs) == dataclasses.asdict(want.obs)
    assert got.profile_dir == want.profile_dir


@pytest.mark.parametrize("flag,match", [
    ("--obs-hbm-attrib", "XLA HLO and xprof"),
    ("--evict-on-straggler", "Queue A item 9")])
def test_cli_refuses_what_is_not_ported(flag, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.config_from_args([flag])


def test_halt_on_unhealthy_across_processes_is_refused(monkeypatch):
    from tpunet_torch.train import loop
    monkeypatch.setattr(loop, "process_count", lambda: 2)
    cfg, _ = cli.config_from_args(["--halt-on-unhealthy"])
    with pytest.raises(NotImplementedError, match="item 2b"):
        loop.Trainer(cfg, device="cpu")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_statsd_datagrams_reach_a_local_socket():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    exp = build_exporters(pcfg.ExportConfig(
        statsd=f"127.0.0.1:{rx.getsockname()[1]}"), Registry())
    assert [e.name for e in exp] == ["statsd"]
    exp[0].write({"kind": "obs_epoch", "mfu": 0.25, "steps": 8,
                  "unit": "examples", "run_id": "r1"})
    exp[0].close()
    payload = rx.recv(65536).decode()
    rx.close()
    assert "tpunet.obs_epoch.mfu:0.25|g|#run_id:r1" in payload
    assert "tpunet.obs_epoch.steps:8|g|#run_id:r1" in payload
    assert "unit" not in payload


def test_line_json_reaches_a_local_http_listener():
    got = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            got.extend(self.rfile.read(n).decode().splitlines())
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        exp = AsyncExporter(HttpLineTransport(
            f"http://127.0.0.1:{srv.server_port}/", timeout=5.0),
            name="http")
        for i in range(5):
            exp.write({"kind": "obs_step", "step": i})
        exp.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert [json.loads(line)["step"] for line in got] == list(range(5))
    assert exp.stats() == {"enqueued": 5, "sent": 5, "send_errors": 0,
                           "dropped": 0}


def test_full_queue_drops_and_counts():
    gate = threading.Event()
    transport = MemoryTransport(gate=gate)
    reg = Registry()
    exp = AsyncExporter(transport, name="mem", queue_size=4,
                        flush_timeout=2.0, registry=reg)
    t0 = time.perf_counter()
    for i in range(50):
        exp.write({"step": i})
    assert time.perf_counter() - t0 < 0.5
    assert reg.counter("export_mem_dropped").value >= 45
    gate.set()
    exp.close()
    stats = exp.stats()
    assert stats["enqueued"] + stats["dropped"] == 50
    assert stats["sent"] == stats["enqueued"] == len(transport.records)


def test_build_exporters_validates_endpoints():
    reg = Registry()
    with pytest.raises(ValueError, match="HOST:PORT"):
        build_exporters(pcfg.ExportConfig(statsd="nonsense"), reg)
    with pytest.raises(ValueError, match="http"):
        build_exporters(pcfg.ExportConfig(http="ftp://x/"), reg)
    with pytest.raises(ValueError):
        build_exporters(pcfg.ExportConfig(webhook="u"), reg)
    assert build_exporters(pcfg.ExportConfig(), reg) == []
    assert math.isfinite(pcfg.ExportConfig().flush_timeout_s)
