"""The port's router (``tpunet_torch.router``) against tpunet's on the CPU.

Three layers, cheapest first: its decisions against the reference's on
the same seeded inputs (affinity keys, replica picks, rendezvous
moves, the autoscale policy's decision sequence, the ``obs_router``
records, the supervisor's child argv and the CLI's exit-2 refusals,
``--aot-cache`` among them); the probe keys and the drain/no-replica
contract with in-process port ``ServeServer`` replicas; and the
end-to-end test: two ``python -m tpunet_torch.serve --device cpu``
children spawned by the port's CLI path, with greedy parity through the
proxy, least-loaded spread, ``/v1/classify`` proxying, a SIGKILL
mid-stream that fails over into a whole stream, and evict + respawn.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tpunet.config import RouterConfig as JaxRouterConfig
from tpunet.obs.registry import Registry as JaxRegistry
from tpunet.router import balance as jax_balance
from tpunet.router import policy as jax_policy
from tpunet.router import records as jax_records
from tpunet.router import replica as jax_replica
from tpunet.serve.chaos import ServeChaosError as JaxServeChaosError
from tpunet.serve.chaos import split_by_replica as jax_split_by_replica
from tpunet_torch.config import (AOT_CACHE_SCOPED_OUT, ModelConfig,
                                 RouterConfig, ServeConfig)
from tpunet_torch.obs.registry import Registry
from tpunet_torch.router import balance, policy, records, replica
from tpunet_torch.router.replica import (DEAD, DRAINING, EVICTED, HEALTHY,
                                         STARTING, ReplicaHandle)
import _torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
STATES = (HEALTHY, HEALTHY, HEALTHY, DRAINING, DEAD, STARTING, EVICTED)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _wait(pred, timeout=20.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out: {what}")


def _post(base, path, obj, timeout=60, headers=()):
    req = urllib.request.Request(
        base + path, json.dumps(obj).encode(),
        {"Content-Type": "application/json", **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path, timeout=10):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# decisions against tpunet's on the same inputs
# ---------------------------------------------------------------------------


def _bodies(seed, n=80):
    """Seeded /v1/generate bodies: sessions, token prompts (some sharing
    a prefix), UTF-8 prompts, and bodies with nothing to be affine on."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, size=24).tolist()
    alphabet = list("abcdefghij klmnop-é€✓")
    out = []
    for i in range(n):
        kind = i % 6
        toks = rng.integers(0, 256, size=int(rng.integers(1, 40))).tolist()
        if kind == 0:
            out.append({"session": f"user-{int(rng.integers(1e6))}",
                        "tokens": toks})
        elif kind == 1:
            out.append({"tokens": toks})
        elif kind == 2:
            out.append({"tokens": shared[:int(rng.integers(1, 24))] + toks})
        elif kind == 3:
            out.append({"prompt": "".join(
                rng.choice(alphabet, size=int(rng.integers(1, 30))))})
        elif kind == 4:
            out.append([{}, {"tokens": []}, {"prompt": ""},
                        {"session": ""}][i % 4])
        else:
            out.append({"tokens": toks, "prompt": "ignored"})
    return out


@pytest.mark.parametrize("prefix", [0, 1, 8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_affinity_keys_equal_tpunets(prefix, seed):
    keys = [balance.affinity_key(b, prefix) for b in _bodies(seed)]
    assert keys == [jax_balance.affinity_key(b, prefix)
                    for b in _bodies(seed)]
    assert any(k is not None for k in keys)
    # The token digest is the one the port's prefix KV cache keys its
    # pages on.
    from tpunet_torch.serve.prefixcache.keys import token_prefix_digest
    if prefix:
        assert balance.affinity_key({"tokens": [1, 2, 3, 99]}, 3) == \
            "t:" + token_prefix_digest([1, 2, 3], 3)


def _fleets(rng, clock):
    """The same made-up replica states as port and tpunet handles."""
    n = int(rng.integers(1, 6))
    ours, theirs = [], []
    for i in range(n):
        state = STATES[int(rng.integers(len(STATES)))]
        attrs = dict(state=state, slots=int(rng.choice([0, 2, 4, 8])),
                     queue_depth=int(rng.integers(0, 9)),
                     active_slots=int(rng.integers(0, 5)),
                     requests_routed=int(rng.integers(0, 3)),
                     backoff_until=float(clock.t + rng.choice([-1, 0, 5])))
        for mod, out in ((replica, ours), (jax_replica, theirs)):
            h = mod.ReplicaHandle(f"r{i}", f"http://127.0.0.1:1{i}",
                                  clock=clock)
            for k, v in attrs.items():
                setattr(h, k, v)
            out.append(h)
    return ours, theirs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pick_replica_equals_tpunets(seed):
    rng = np.random.default_rng(100 + seed)
    clock = FakeClock()
    n_some = 0
    for body in _bodies(seed, n=60):
        ours, theirs = _fleets(rng, clock)
        key = balance.affinity_key(body, 16)
        slack = float(rng.choice([0.0, 0.25, 0.5, 2.0]))
        exclude = {f"r{i}" for i in range(len(ours)) if rng.random() < 0.2}
        rep, hit = balance.pick_replica(ours, key, affinity_slack=slack,
                                        exclude=exclude)
        ref, ref_hit = jax_balance.pick_replica(
            theirs, key, affinity_slack=slack, exclude=exclude)
        assert (getattr(rep, "name", None), hit) == \
            (getattr(ref, "name", None), ref_hit)
        n_some += rep is not None
    assert n_some > 10


def test_pick_least_loaded_exclude_and_affinity_until_overloaded():
    def handle(name, *, slots=4, queue=0, active=0, state=HEALTHY):
        h = ReplicaHandle(name, f"http://127.0.0.1:1{name[-1]}")
        h.state, h.slots = state, slots
        h.queue_depth, h.active_slots = queue, active
        return h

    a = handle("r0", queue=4, active=4)       # load 2.0
    b = handle("r1", queue=0, active=1)       # load 0.25
    c = handle("r2", state=DEAD)
    assert balance.pick_replica([a, b, c]) == (b, False)
    assert balance.pick_replica([a, b, c], exclude={"r1"})[0] is a
    assert balance.pick_replica([c]) == (None, False)
    a, b = handle("r0"), handle("r1")
    key = "s:conversation-42"
    pref = balance.preferred_replica([a, b], key)
    other = b if pref is a else a
    assert balance.pick_replica([a, b], key, affinity_slack=0.5) == \
        (pref, True)
    pref.queue_depth, pref.active_slots = 4, 4
    assert balance.pick_replica([a, b], key, affinity_slack=0.5) == \
        (other, False)


@pytest.mark.parametrize("removed", ["r0", "r1", "r2", "r3"])
def test_rendezvous_moves_only_the_removed_replicas_keys(removed):
    ours = [ReplicaHandle(f"r{i}", "http://x") for i in range(4)]
    theirs = [jax_replica.ReplicaHandle(f"r{i}", "http://x")
              for i in range(4)]
    keys = [f"s:user-{i}" for i in range(200)]
    before = {k: balance.preferred_replica(ours, k).name for k in keys}
    assert before == {k: jax_balance.preferred_replica(theirs, k).name
                      for k in keys}
    survivors = [r for r in ours if r.name != removed]
    after = {k: balance.preferred_replica(survivors, k).name for k in keys}
    assert after == {k: jax_balance.preferred_replica(
        [r for r in theirs if r.name != removed], k).name for k in keys}
    moved = sum(after[k] != before[k] for k in keys)
    assert moved == sum(before[k] == removed for k in keys) > 0


def _probe_series(seed, n=300):
    """Seeded probe rounds: (dt, queue_depth, slots, ttft_p99_s,
    replicas) in phases of pressure, idleness, boot (0 slots) and noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phase = (i // 25) % 4
        slots = 0 if phase == 3 and rng.random() < 0.7 \
            else int(rng.choice([4, 8, 16]))
        queue = {0: int(rng.integers(8, 40)), 1: 0,
                 2: int(rng.integers(0, 12))}.get(phase, 0)
        ttft = None if rng.random() < 0.3 else float(rng.exponential(0.2))
        out.append((float(rng.choice([0.5, 1.0, 3.0])), queue, slots, ttft,
                    int(rng.integers(1, 6))))
    return out


SCRIPTED = ([(1.0, 16, 8, None, 2)] * 3 + [(1.0, 16, 8, None, 3)] * 5
            + [(11.0, 16, 8, None, 3)] + [(1.0, 0, 8, None, 2)] * 3
            + [(11.0, 0, 8, None, 1)] * 6 + [(1.0, 0, 0, None, 2)] * 10
            + [(1.0, 0, 8, 0.25, 2)] * 3)


@pytest.mark.parametrize("cfg_kw", [
    dict(scale_window_probes=3, scale_cooldown_s=10.0, max_replicas=4),
    dict(scale_window_probes=5, scale_cooldown_s=2.0, ttft_slo_ms=300.0,
         min_replicas=2, max_replicas=4),
    dict(scale_window_probes=1, scale_cooldown_s=0.0, ttft_slo_ms=100.0,
         scale_up_queue_per_slot=0.5, scale_down_queue_per_slot=0.5),
])
@pytest.mark.parametrize("series", ["seed0", "seed1", "scripted"])
def test_autoscale_policy_gives_tpunets_decisions(cfg_kw, series):
    rounds = SCRIPTED if series == "scripted" \
        else _probe_series(int(series[-1]))
    clocks = FakeClock(), FakeClock()
    ours = policy.AutoscalePolicy(RouterConfig(**cfg_kw), clock=clocks[0])
    theirs = jax_policy.AutoscalePolicy(JaxRouterConfig(**cfg_kw),
                                        clock=clocks[1])
    got, ref = [], []
    for dt, queue, slots, ttft, n in rounds:
        for clock, pol, out in ((clocks[0], ours, got),
                                (clocks[1], theirs, ref)):
            clock.t += dt
            out.append((pol.observe(queue_depth=queue, slots=slots,
                                    ttft_p99_s=ttft, replicas=n),
                        pol.slo_burn(ttft), pol.last_decision))
    assert got == ref
    decisions = {d for d, _, _ in got}
    assert policy.SCALE_UP in decisions


def test_autoscale_policy_scripted_cases():
    """The reference's own cases on the port: sustained pressure fires
    once then holds through the cooldown; down needs idleness and stops
    at min_replicas; boot (0 slots) is not idleness; max bounds."""
    clock = FakeClock()
    pol = policy.AutoscalePolicy(RouterConfig(
        scale_window_probes=3, scale_cooldown_s=10.0, min_replicas=1,
        max_replicas=4), clock=clock)

    def obs(q, s, n, ttft=None):
        return pol.observe(queue_depth=q, slots=s, ttft_p99_s=ttft,
                           replicas=n)

    assert [obs(16, 8, 2) for _ in range(3)] == [None, None,
                                                 policy.SCALE_UP]
    assert [obs(16, 8, 3) for _ in range(5)] == [None] * 5
    clock.t += 11.0
    assert obs(16, 8, 3) == policy.SCALE_UP
    clock.t += 11.0
    assert [obs(0, 8, 2) for _ in range(3)] == [None, None,
                                                policy.SCALE_DOWN]
    clock.t += 11.0
    assert [obs(0, 8, 1) for _ in range(6)] == [None] * 6
    assert [obs(0, 0, 2) for _ in range(10)] == [None] * 10
    assert [obs(16, 8, 4) for _ in range(6)] == [None] * 6


def _registries(seed):
    """A port and a tpunet registry after the same seeded router
    traffic."""
    rng = np.random.default_rng(seed)
    regs = Registry(), JaxRegistry()
    names = ("requests", "rerouted", "rejected", "affinity_hits",
             "failovers", "evictions", "respawns", "scale_ups",
             "scale_downs", "probe_failures")
    for _ in range(int(rng.integers(0, 200))):
        name = names[int(rng.integers(len(names)))]
        e2e = float(rng.exponential(0.3))
        for reg in regs:
            reg.counter(f"router_{name}_total").inc()
            reg.histogram("router_e2e_s").observe(e2e)
    return regs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_records_equal_tpunets(seed):
    rng = np.random.default_rng(seed)
    ours, _ = _fleets(rng, FakeClock())
    rows = [h.view() for h in ours]
    reg, jax_reg = _registries(seed)
    for final in (False, True):
        for burn in (None, float(rng.exponential(1.0))):
            kw = dict(replicas=rows, uptime_s=float(rng.uniform(0, 1e4)),
                      window_s=float(rng.uniform(0, 60)),
                      scale_decision=str(rng.choice(
                          ["hold", "scale_up", "scale_down"])),
                      ttft_slo_burn=burn, final=final)
            assert records.build_router_record(reg, **kw) == \
                jax_records.build_router_record(jax_reg, **kw)
    for kw in (dict(replica="r1", url="http://h:1", cause="probe_failures"),
               dict(cause="policy", old_replicas=2, new_replicas=3),
               dict(replica="r0", cause="webhook:straggler",
                    detail={"factor": 3.0}),
               dict()):
        for event in ("evict", "respawn", "scale_up", "failover"):
            got = records.build_router_event(event, **kw)
            ref = jax_records.build_router_event(event, **kw)
            assert abs(got.pop("time") - ref.pop("time")) < 5.0
            assert got == ref


def test_router_config_has_tpunets_fields_and_defaults():
    import dataclasses
    ours = {f.name: f.default for f in dataclasses.fields(RouterConfig)}
    assert ours.pop("aot_cache") == ""
    assert ours == {f.name: f.default
                    for f in dataclasses.fields(JaxRouterConfig)}


def test_supervisor_child_argv_spawns_the_port_without_aot(tmp_path):
    from tpunet.router.supervisor import Supervisor as JaxSupervisor
    from tpunet_torch.router.supervisor import Supervisor
    tail = ["--checkpoint-dir", "ck", "--slots", "4"]
    chaos = "kill@tokens=5:replica=0;slow-stream@ms=9"
    sup = Supervisor(tail, directory=str(tmp_path), chaos=chaos)
    ref = JaxSupervisor(tail, directory=str(tmp_path), chaos=chaos)
    for index in (0, 1):
        argv = sup.child_argv(index, 8123, f"router-replica-{index}")
        assert argv[:3] == [sys.executable, "-m", "tpunet_torch.serve"]
        assert argv[3:] == ref.child_argv(
            index, 8123, f"router-replica-{index}")[3:]
        assert argv[argv.index("--port") + 1] == "8123"
        assert argv[argv.index("--metrics-dir") + 1].endswith(
            f"replica-{index}")
        assert argv[-4:] == tail
        assert "--aot-cache" not in argv
    assert sup.child_argv(0, 1, "x")[
        sup.child_argv(0, 1, "x").index("--chaos") + 1] == \
        "kill@tokens=5;slow-stream@ms=9"
    for kw in (dict(aot_cache="/aot"), dict(serve_args=["--aot-cache", "/a"]),
               dict(serve_args=["--aot-cache=/a"])):
        args = kw.pop("serve_args", tail)
        with pytest.raises(NotImplementedError) as e:
            Supervisor(args, **kw)
        assert str(e.value) == AOT_CACHE_SCOPED_OUT
    with pytest.raises(NotImplementedError):
        RouterConfig(aot_cache="/aot")


def test_cli_aot_cache_exits_2_before_any_child(tmp_path):
    """``python -m tpunet_torch.router --aot-cache DIR`` exits 2 with
    the reason at boot: no metrics dir, no child log, no child."""
    mdir = tmp_path / "m"
    out = subprocess.run(
        [sys.executable, "-m", "tpunet_torch.router", "--spawn", "2",
         "--metrics-dir", str(mdir), "--aot-cache", str(tmp_path / "aot"),
         "--", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=_torch_threads.child_env())
    assert out.returncode == 2, out.stderr
    assert out.stderr.strip() == \
        f"python -m tpunet_torch.router: error: {AOT_CACHE_SCOPED_OUT}"
    assert not mdir.exists() and not (tmp_path / "aot").exists()


def _bad_slo_file(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text("{")
    return str(path)


@pytest.mark.parametrize("case", ["aot_passthrough", "chaos", "slo",
                                  "nothing", "slo_missing"])
def test_cli_refusals_exit_2(tmp_path, capsys, case):
    from tpunet.obs.slo import SloPolicyError as JaxSloPolicyError
    from tpunet.obs.slo import load_policy as jax_load_policy
    from tpunet_torch.router.__main__ import build_argparser, build_server
    prog = "python -m tpunet_torch.router: error: "
    if case == "aot_passthrough":
        argv = ["--spawn", "1", "--", "--aot-cache", "x"]
        want = prog + AOT_CACHE_SCOPED_OUT
    elif case == "chaos":
        argv = ["--spawn", "1", "--chaos", "kill@tokens=5;bogus@x"]
        with pytest.raises(JaxServeChaosError) as e:
            jax_split_by_replica("kill@tokens=5;bogus@x")
        want = prog + str(e.value)
    elif case in ("slo", "slo_missing"):
        path = _bad_slo_file(tmp_path) if case == "slo" \
            else str(tmp_path / "absent.json")
        argv = ["--spawn", "1", "--slo-policy", path]
        with pytest.raises((JaxSloPolicyError, OSError)) as e:
            jax_load_policy(path)
        want = prog + f"--slo-policy: {e.value}"
    else:
        argv = []
        want = prog + ("nothing to route to — give --replica URL "
                       "(repeatable) and/or --spawn N")
    with pytest.raises(SystemExit) as exc:
        build_server(build_argparser().parse_args(argv))
    assert exc.value.code == 2
    assert capsys.readouterr().err.strip() == want


def test_on_page_evicts_only_named_evictable_replica():
    from tpunet_torch.router.core import Router
    router = Router(RouterConfig(emit_every_s=0.0),
                    replica_urls=["http://127.0.0.1:1", "http://127.0.0.1:2"])
    for i, rep in enumerate(router.replicas):
        rep.run_id, rep.state = f"router-replica-{i}", HEALTHY
    assert not router.on_page({"kind": "obs_alert", "reason": "loss_spike",
                               "run_id": "router-replica-0"})
    assert not router.on_page({"kind": "obs_alert", "reason": "straggler",
                               "run_id": "nobody"})
    assert router.on_page({"kind": "obs_alert", "reason": "straggler",
                           "run_id": "router-replica-1/0",
                           "detail": {"factor": 3.0}})
    assert [r.state for r in router.replicas] == [HEALTHY, EVICTED]
    assert not router.on_page({"kind": "obs_crash",
                               "run_id": "router-replica-1"})
    assert router.registry.snapshot()["router_evictions_total"] == 1


# ---------------------------------------------------------------------------
# in-process port replicas
# ---------------------------------------------------------------------------

TINY = ModelConfig(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2,
                   dropout_rate=0.0, dtype="float32", vocab_size=256,
                   max_seq_len=64)


@pytest.fixture(scope="module")
def lm():
    from tpunet_torch.models import create_model
    return create_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(0))


def _port_replica(lm, run_id, **cfg_kw):
    from tpunet_torch.serve import Engine, ServeServer
    cfg = dict(slots=2, queue_max=8, prefill_buckets=(16,),
               default_max_new_tokens=8, emit_every_s=0.0)
    cfg.update(cfg_kw)
    return ServeServer(Engine(lm, ServeConfig(**cfg)), port=0,
                       run_id=run_id).start()


def test_port_replica_metrics_carry_the_probe_keys(lm):
    """The four ``/metrics`` keys ``replica.py`` reads are on a port
    replica's snapshot, and both packages' handles probe it alike."""
    srv = _port_replica(lm, "port-0")
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, out, _ = _post(base, "/v1/generate",
                             {"tokens": [5, 9, 2], "max_new_tokens": 4})
        assert code == 200
        snap = _get(base, "/metrics")
        for key in ("serve_queue_depth", "serve_active_slots",
                    "serve_requests_total", "serve_ttft_s_p99"):
            assert key in snap, key
        ours = ReplicaHandle("r0", base)
        theirs = jax_replica.ReplicaHandle("r0", base)
        assert ours.probe() and theirs.probe()
        assert ours.view() == theirs.view()
        assert ours.state == HEALTHY and ours.run_id == "port-0"
        assert ours.serve_requests_total == 1 and ours.slots == 2
        assert ours.ttft_p99_s == theirs.ttft_p99_s is not None
    finally:
        srv.drain(timeout=10.0)


def test_router_honors_drain_retry_after_and_no_replica_503(lm):
    """A draining port replica's 503 + Retry-After backs it off; with
    every replica draining the router answers 503 with Retry-After."""
    from tpunet_torch.router import Router, RouterServer
    reps = [_port_replica(lm, f"port-{i}", drain_timeout_s=30.0)
            for i in range(2)]
    router = Router(RouterConfig(probe_interval_s=0.1, emit_every_s=0.0,
                                 affinity_prefix=0, route_retries=2),
                    replica_urls=[f"http://127.0.0.1:{r.port}"
                                  for r in reps])
    server = RouterServer(router, port=0).start()
    base = f"http://127.0.0.1:{server.port}"

    def drain_admissions(srv):
        srv.engine._draining.set()
        srv.engine.queue.close()

    try:
        _wait(lambda: router.healthy_count() == 2, what="2 healthy")
        drain_admissions(reps[0])
        for _ in range(4):
            code, out, _ = _post(base, "/v1/generate",
                                 {"tokens": [1, 2], "max_new_tokens": 2})
            assert code == 200, out
        served = [r.engine.registry.counter("serve_requests_total").value
                  for r in reps]
        assert served == [0, 4]
        handle = next(r for r in router.replicas if r.run_id == "port-0")
        assert handle.backoff_until > 0
        drain_admissions(reps[1])
        _wait(lambda: not any(r.routable() for r in router.replicas),
              what="both backed off")
        code, out, headers = _post(base, "/v1/generate", {"tokens": [1]})
        assert code == 503 and out["error"] in ("no_replicas",
                                                "replica_busy")
        assert "Retry-After" in headers
        assert router.registry.snapshot()["router_rejected_total"] >= 1
    finally:
        server.drain()
        for r in reps:
            r.drain(timeout=10.0)


# ---------------------------------------------------------------------------
# end-to-end: 2 spawned port replicas behind the port's router
# ---------------------------------------------------------------------------

LM_ARGS = ["--vit-hidden", "32", "--vit-depth", "2", "--vit-heads", "2",
           "--vocab-size", "256", "--max-seq-len", "512"]


def pin_session_to(name: str) -> str:
    """A session whose rendezvous-preferred replica over the supervised
    fleet's names r0/r1 is ``name``."""
    fakes = [ReplicaHandle("r0", "http://x"), ReplicaHandle("r1", "http://x")]
    return next(s for s in (f"sess{i}" for i in range(256))
                if balance.preferred_replica(fakes, f"s:{s}").name == name)


def _classifier_checkpoint(directory: Path):
    """A seeded MobileNetV2 (the serve CLI's classifier) with seeded BN
    affines and one batch's statistics, so its logits do not collapse
    to a uniform distribution."""
    from tpunet_torch.models import create_model
    from tpunet_torch.models.mobilenetv2 import BN, BN_MOMENTUM
    model = create_model(ModelConfig(name="mobilenet_v2", dropout_rate=0.0,
                                     dtype="float32"), device="cpu",
                         generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    bns = [m for m in model.modules() if isinstance(m, BN)]
    with torch.no_grad():
        for bn in bns:
            c = bn.weight.shape[0]
            bn.weight.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, c).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(
                rng.normal(0.0, 0.1, c).astype(np.float32)))
            bn.running_mean.zero_()
            bn.running_var.zero_()
        model(torch.from_numpy(rng.normal(size=(4, 3, 32, 32)).astype(
            np.float32)), train=True)
        for bn in bns:
            bn.running_mean.div_(1 - BN_MOMENTUM)
            bn.running_var.div_(1 - BN_MOMENTUM)
    directory.mkdir(parents=True)
    torch.save(model.state_dict(), directory / "best.pth")


def test_router_end_to_end_two_spawned_port_replicas(tmp_path, monkeypatch):
    from tpunet_torch.infer.generate import load_lm
    from tpunet_torch.infer.predict import Predictor
    from tpunet_torch.models.lm import generate
    from tpunet_torch.router.__main__ import build_argparser, build_server
    from tpunet_torch.config import DataConfig

    _torch_threads.one_thread_children(monkeypatch)
    ck = tmp_path / "cls"
    _classifier_checkpoint(ck)
    argv = ["--spawn", "2", "--port", "0", "--probe-interval-s", "0.2",
            "--probe-timeout-s", "2", "--unhealthy-after", "2",
            "--boot-timeout-s", "90", "--respawn-backoff-s", "0.2",
            "--emit-every-s", "0.5", "--min-replicas", "2",
            "--max-replicas", "2", "--metrics-dir", str(tmp_path / "m"),
            "--chaos", "slow-stream@ms=10", "--",
            "--checkpoint-dir", "", "--device", "cpu", "--slots", "2",
            "--prefill-buckets", "16,64,256", "--queue-max", "16",
            "--max-new-tokens", "64", "--classifier-checkpoint-dir",
            str(ck), "--classifier-image-size", "32"] + LM_ARGS
    server = build_server(build_argparser().parse_args(argv)).start()
    router = server.router
    base = f"http://127.0.0.1:{server.port}"
    model = load_lm(ModelConfig(name="lm", vit_hidden=32, vit_depth=2,
                                vit_heads=2, vocab_size=256,
                                max_seq_len=512, dropout_rate=0.0),
                    "", device="cpu")

    def greedy(tokens, n):
        return generate(model, torch.tensor([tokens]), n)[
            0, len(tokens):].tolist()

    try:
        _wait(lambda: router.healthy_count() == 2, timeout=90,
              what="both replicas healthy (cold boot)")
        assert all(r.run_id.startswith("router-replica-")
                   for r in router.replicas)

        # -- greedy parity through the proxy ---------------------------
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, 256, size=7).tolist()
        code, out, _ = _post(base, "/v1/generate",
                             {"tokens": prompt, "max_new_tokens": 6})
        assert code == 200, out
        assert out["tokens"] == greedy(prompt, 6)

        # -- least-loaded spread ---------------------------------------
        prompts = [rng.integers(0, 256, size=5).tolist() for _ in range(8)]
        results = [None] * 8

        def worker(i):
            results[i] = _post(base, "/v1/generate",
                               {"tokens": prompts[i], "max_new_tokens": 24})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None and r[0] == 200 for r in results)
        assert [r[1]["tokens"] for r in results] == \
            [greedy(p, 24) for p in prompts]
        routed = {r["name"]: r["requests_routed"]
                  for r in _get(base, "/replicas")["replicas"]}
        assert all(v >= 1 for v in routed.values()), routed

        # -- /v1/classify through the proxy ----------------------------
        img = rng.integers(0, 256, (32, 32, 3)).astype(int).tolist()
        code, out, _ = _post(base, "/v1/classify",
                             {"image": img, "topk": 3})
        assert code == 200, out
        pred = Predictor(ModelConfig(name="mobilenet_v2", dropout_rate=0.0),
                         DataConfig(image_size=32),
                         checkpoint=str(ck / "best.pth"), device="cpu")
        ref = pred.predict_probs(np.asarray(img, np.uint8))
        got = np.asarray([out["probs"][n] for n in pred.class_names])
        np.testing.assert_allclose(got, ref, atol=1e-6)
        # (bf16 probabilities may tie: compare the top-1's probability)
        assert out["topk"][0]["prob"] == pytest.approx(ref.max(), abs=1e-6)
        assert float(ref.max() - ref.min()) > 0.05

        # -- SIGKILL mid-stream -> failover into a whole stream --------
        session = pin_session_to("r0")
        victim = router.supervisor.get(0)
        # Idle fleet on the probes: the affinity pick is r0's.
        _wait(lambda: all(r.active_slots == 0 and r.queue_depth == 0
                          for r in router.replicas), what="idle fleet")
        req = urllib.request.Request(
            base + "/v1/generate",
            json.dumps({"tokens": prompt, "max_new_tokens": 120,
                        "stream": True, "session": session}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            lines = [json.loads(resp.readline())]
            assert "token" in lines[0]
            assert router.replicas[0].requests_routed >= 1
            os.kill(victim.pid, signal.SIGKILL)
            lines += [json.loads(line) for line in resp]
        done = lines[-1]
        assert done.get("done") and done["finish_reason"] == "length", done
        assert "error" not in done and done["failover_count"] >= 1
        assert [ev["token"] for ev in lines if "token" in ev] == \
            greedy(prompt, 120)
        assert [ev["i"] for ev in lines if "token" in ev] == \
            list(range(120))

        # -- evict -> respawn -> healthy -------------------------------
        _wait(lambda: router.registry.snapshot().get(
            "router_respawns_total", 0) >= 1, timeout=30, what="respawn")
        _wait(lambda: router.healthy_count() == 2, timeout=90,
              what="victim respawned healthy")
        assert router.supervisor.get(0).pid != victim.pid
        code, out, _ = _post(base, "/v1/generate",
                             {"tokens": prompts[2], "max_new_tokens": 4,
                              "session": session})
        assert code == 200 and out["tokens"] == greedy(prompts[2], 4)
        snap = _get(base, "/metrics")
        assert snap["router_evictions_total"] >= 1
        assert snap["router_failovers_total"] >= 1
    finally:
        server.drain()
        for index in (0, 1):
            proc = router.supervisor.get(index)
            if proc is not None and proc.alive():
                proc.proc.kill()

    recs = [json.loads(line) for line in
            (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    routers = [r for r in recs if r.get("kind") == "obs_router"]
    windows = [r for r in routers if not r.get("event")]
    assert windows and windows[-1]["final"]
    assert windows[-1]["failovers_total"] >= 1
    assert {"failover", "evict", "respawn"} <= \
        {r["event"] for r in routers if r.get("event")}
