"""The port's serve-tier fault injection (``tpunet_torch.serve.chaos``, a
copy of ``tpunet/serve/chaos.py``) on the CPU: the grammar and replica
scoping cases of tests/test_failover.py against both packages, hooks that
fire deterministically (the drop-probe draws equal tpunet's for the same
seed), a ``drop-probe`` ``/healthz`` answering 500 for exactly the seeded
probes, the engine's hooks (stall in the loop, kill at a prefill and at a
token, the ``chaos`` field of ``obs_serve``), and ``python -m
tpunet_torch.serve --chaos kill@tokens=N`` as a subprocess: a streamed
``/v1/generate`` receives exactly N tokens, then the connection drops and
the process dies by SIGKILL.
"""

import json
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tpunet.serve import chaos as jax_chaos
from tpunet_torch.config import ModelConfig, ServeConfig
from tpunet_torch.models import create_model
from tpunet_torch.serve import Engine, ServeServer
from tpunet_torch.serve.chaos import (ServeChaos, ServeChaosError,
                                      split_by_replica, spec_for_replica)
import _torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TINY = ModelConfig(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2,
                   dropout_rate=0.0, dtype="float32", vocab_size=64,
                   max_seq_len=64)
GOOD = ("kill@tokens=5;stall@tokens=3:ms=100;drop-probe@prob=0.5:seed=7;"
        "slow-stream@ms=2;kill@prefill")
BAD = ("boom@tokens=1", "kill@step=1", "kill@tokens", "stall@tokens=3",
       "drop-probe@prob=0.5", "drop-probe@prob=2:seed=1", "kill@tokens=x",
       "kill@tokens=1:wat=2", "")


@pytest.fixture(scope="module")
def lm():
    return create_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(0))


def recorder():
    """kill/sleep stand-ins that record their calls."""
    calls = {"kill": [], "sleep": []}
    return calls, dict(kill=lambda pid, sig: calls["kill"].append(sig),
                       sleep=calls["sleep"].append)


@pytest.mark.parametrize("spec", (GOOD,) + BAD)
def test_chaos_parse_good_and_bad(spec):
    """Each spec parses (and renders) as tpunet's does, or fails in
    both."""
    try:
        want = jax_chaos.ServeChaos.parse(spec).render()
    except jax_chaos.ServeChaosError:
        with pytest.raises(ServeChaosError):
            ServeChaos.parse(spec)
        return
    ch = ServeChaos.parse(spec)
    assert ch.render() == want
    assert len(ch.events) == 5 and want.startswith("kill@tokens=5")


def test_chaos_replica_scoping():
    spec = "kill@tokens=5:replica=0;slow-stream@ms=10;" \
           "stall@tokens=2:ms=50:replica=1"
    assert split_by_replica(spec) == jax_chaos.split_by_replica(spec) == {
        0: "kill@tokens=5", None: "slow-stream@ms=10",
        1: "stall@tokens=2:ms=50"}
    for i, want in ((0, "kill@tokens=5;slow-stream@ms=10"),
                    (1, "slow-stream@ms=10;stall@tokens=2:ms=50"),
                    (2, "slow-stream@ms=10")):
        assert spec_for_replica(spec, i) == want
        assert jax_chaos.spec_for_replica(spec, i) == want
    assert spec_for_replica("", 0) == ""
    with pytest.raises(ServeChaosError):
        split_by_replica("kill@tokens=bad:replica=0")


def test_chaos_hooks_fire_deterministically():
    calls, kw = recorder()
    ch = ServeChaos.parse(
        "kill@tokens=3;kill@prefill=2;stall@tokens=2:ms=40", **kw)
    flushes = []
    ch.before_kill = lambda: flushes.append(len(calls["kill"]))
    ch.on_token()                      # 1: nothing
    assert not calls["kill"] and not ch.stalled
    ch.on_token()                      # 2: stall arms
    assert ch.stalled and ch.stall_ms == 40.0
    ch.maybe_stall()
    assert calls["sleep"] == [0.04]
    ch.on_token()                      # 3: kill fires ONCE
    ch.on_token()
    assert calls["kill"] == [signal.SIGKILL]
    ch.on_prefill()                    # ordinal 1: below the =2 mark
    assert len(calls["kill"]) == 1
    ch.on_prefill()                    # ordinal 2: fires
    assert len(calls["kill"]) == 2
    assert flushes == [0, 1]           # each kill flushed first
    # drop-probe: same seed => same afflicted probes, tpunet's too.
    runs = []
    for cls in (ServeChaos, jax_chaos.ServeChaos):
        probe = cls.parse("drop-probe@prob=0.5:seed=11",
                          kill=lambda *a: None, sleep=lambda s: None)
        runs.append([probe.on_probe() for _ in range(16)])
    assert runs[0] == runs[1] and any(runs[0]) and not all(runs[0])


def test_engine_fires_the_prefill_token_and_stall_hooks(lm):
    """The engine's hook sites: the loop's stall point, the prefill
    before its device call, each pushed token (the kill at the third
    token finds three tokens pushed), and a chaos-armed engine's
    obs_serve record names its spec."""
    eng = Engine(lm, ServeConfig(slots=2, prefill_buckets=(16,),
                                 emit_every_s=0.0,
                                 chaos="kill@tokens=3;stall@tokens=2:ms=7"))
    calls, kw = recorder()
    pushed = []
    ch = ServeChaos.parse(eng.chaos.render(), **kw)
    ch.before_kill = lambda: pushed.append(len(req.tokens))
    eng.chaos = ch
    req = eng.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=5)
    for _ in range(6):
        eng._iterate()
    assert req.tokens and len(req.tokens) == 5
    assert ch._prefills == 1 and ch._tokens == 5
    assert calls["kill"] == [signal.SIGKILL] and pushed == [3]
    assert calls["sleep"] and set(calls["sleep"]) == {0.007}
    records = []

    class Sink:
        write = records.append

    eng.registry.add_sink(Sink)
    eng._emit_record()
    assert records[-1]["chaos"] == ch.render()


def http_get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_drop_probe_healthz_answers_500_for_the_seeded_probes(lm):
    spec = "drop-probe@prob=0.5:seed=11"
    srv = ServeServer(Engine(lm, ServeConfig(
        slots=2, prefill_buckets=(16,), emit_every_s=0.0, chaos=spec)),
        port=0).start()
    try:
        codes = [http_get(f"http://127.0.0.1:{srv.port}/healthz")
                 for _ in range(16)]
    finally:
        srv.drain(timeout=10.0)
    want = ServeChaos.parse(spec, kill=lambda *a: None,
                            sleep=lambda s: None)
    assert codes == [500 if want.on_probe() else 200 for _ in range(16)]
    assert 500 in codes and 200 in codes


def test_serve_cli_killed_after_n_streamed_tokens(tmp_path):
    """A real SIGKILL mid-stream: the CLI with ``--chaos kill@tokens=5``
    streams exactly 5 token lines (indices 0..4), no done frame, and the
    process exits by signal 9."""
    n = 5
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpunet_torch.serve", "--checkpoint-dir", "",
         "--device", "cpu", "--vit-hidden", "32", "--vit-depth", "2",
         "--vit-heads", "2", "--vocab-size", "64", "--max-seq-len", "64",
         "--prefill-buckets", "16", "--slots", "2", "--port", str(port),
         "--metrics-dir", str(tmp_path / "m"), "--chaos",
         f"kill@tokens={n}"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env=_torch_threads.child_env())
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline:
            assert proc.poll() is None, "serve CLI exited early"
            try:
                if http_get(base + "/healthz", timeout=2) == 200:
                    break
            except OSError:
                time.sleep(0.1)
        req = urllib.request.Request(
            base + "/v1/generate",
            json.dumps({"tokens": [5, 9, 2], "max_new_tokens": 20,
                        "stream": True}).encode(),
            {"Content-Type": "application/json"})
        lines = []
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                for line in r:
                    if line.strip():
                        lines.append(json.loads(line))
        except (OSError, ValueError):
            pass                          # the connection dropped
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert [ev.get("i") for ev in lines] == list(range(n)), lines
    assert not any(ev.get("done") for ev in lines)
    assert rc == -signal.SIGKILL
