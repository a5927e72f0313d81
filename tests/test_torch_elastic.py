"""The port's elastic package (tpunet_torch/elastic/) against tpunet's:
chaos specs, renders, errors and injections; filesystem rendezvous;
``obs_elastic`` records and markers; the agent supervising stub
children (exit codes, argv, records); the child's launcher variables;
and the agent CLI with torch unimportable."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import _torch_threads  # noqa: E402,F401

from tpunet.elastic import chaos as jax_chaos_mod
from tpunet.elastic import events as jax_events
from tpunet.elastic.agent import AgentConfig as JaxAgentConfig
from tpunet.elastic.agent import ElasticAgent as JaxElasticAgent
from tpunet.elastic.rendezvous import QuorumError as JaxQuorumError
from tpunet.elastic.rendezvous import Rendezvous as JaxRendezvous
from tpunet_torch.elastic import chaos as chaos_mod
from tpunet_torch.elastic import events
from tpunet_torch.elastic.agent import (EXIT_DONE, EXIT_QUORUM,
                                        EXIT_RESTARTS, LAUNCHER_VARS,
                                        STATE_META, AgentConfig,
                                        ElasticAgent)
from tpunet_torch.elastic.chaos import Chaos
from tpunet_torch.elastic.rendezvous import QuorumError, Rendezvous

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos_mod.clear()
    jax_chaos_mod.clear()


# ---------------------------------------------------------------- chaos

SPECS = [
    "kill@step=5",
    "kill@step=5; slow@step=3:delay=0.5:steps=2 ;ioerr@save=1:fails=2:host=1",
    "kill@ckpt=2:gen=0;slow@step=8:delay=3:steps=4:gen=0",
    "sigterm@step=8:again=1.5:host=0",
    "slow@prob=0.25:delay=0.1:seed=7:host=1",
    "ioerr@restore:fails=3",
    "ioerr@restore=2",
]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_parse_and_render_as_tpunets(spec):
    got, want = Chaos.parse(spec), jax_chaos_mod.Chaos.parse(spec)
    assert got.render() == want.render()
    assert [(e.kind, e.where, e.at, e.params) for e in got.events] == \
        [(e.kind, e.where, e.at, e.params) for e in want.events]


@pytest.mark.parametrize("bad", [
    "", "kill", "kill@banana=1", "slow@step=3", "kill@step=x",
    "slow@prob=0.5:delay=1", "slow@prob=2:delay=1:seed=1",
    "ioerr@save=1:bogus=2", "sigterm@step", "bogus@step=1",
    "slow@step=1:delay=x", "kill@ckpt", ";;",
])
def test_chaos_errors_as_tpunets(bad):
    with pytest.raises(jax_chaos_mod.ChaosSpecError) as want:
        jax_chaos_mod.Chaos.parse(bad)
    with pytest.raises(chaos_mod.ChaosSpecError) as got:
        Chaos.parse(bad)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def _drive(mod, spec, steps=16, **kw):
    """The injections of ``spec`` over ``steps`` steps, two saves and a
    restore, through an injected kill and sleep."""
    calls = []
    c = mod.Chaos.parse(spec, kill=lambda pid, sig: calls.append(
        ("kill", int(sig))), sleep=lambda s: calls.append(("sleep", s)), **kw)
    for s in range(steps):
        c.step(s)
        calls.append(("step", s))
    for index in (1, 2):
        for attempt in range(4):
            try:
                c.save_attempt(index, attempt)
                calls.append(("save_ok", index, attempt))
            except OSError as e:
                calls.append(("save_err", index, attempt, str(e)))
        c.save_in_flight(index)
    for attempt in range(3):
        try:
            c.restore_attempt(1, attempt)
            calls.append(("restore_ok", attempt))
        except OSError as e:
            calls.append(("restore_err", attempt, str(e)))
    return calls, [e.fired for e in c.events]


@pytest.mark.parametrize("spec,kw", [
    ("kill@step=3:host=1", {"process_index": 1}),
    ("kill@step=3:host=1", {"process_index": 0}),
    ("kill@step=1:gen=1", {"generation": 1}),
    ("kill@step=1:gen=0", {"generation": 1}),
    ("kill@ckpt=2:gen=0;slow@step=8:delay=3:steps=4:gen=0", {}),
    ("slow@step=4:delay=0.25:steps=3", {}),
    ("slow@prob=0.5:delay=0.1:seed=7", {}),
    ("slow@prob=0.3:delay=0.2:seed=11:host=0", {}),
    ("ioerr@save=2:fails=2;ioerr@restore=1", {}),
    ("ioerr@save=1:fails=9", {}),
    ("sigterm@step=2", {}),
])
def test_chaos_injections_as_tpunets(spec, kw):
    assert _drive(chaos_mod, spec, **kw) == _drive(jax_chaos_mod, spec, **kw)


def test_chaos_seeded_prob_afflicts_the_same_steps():
    def fired(mod, seed):
        out = []
        c = mod.Chaos.parse(f"slow@prob=0.5:delay=0.1:seed={seed}",
                            sleep=lambda s: out.append(s))
        steps = []
        for s in range(64):
            n = len(out)
            c.step(s)
            if len(out) > n:
                steps.append(s)
        return steps

    for seed in (7, 8, 123):
        assert fired(chaos_mod, seed) == fired(jax_chaos_mod, seed)
    assert 0 < len(fired(chaos_mod, 7)) < 64
    assert fired(chaos_mod, 7) != fired(chaos_mod, 8)


def test_chaos_sigterm_escalation_sends_a_second_signal():
    got = []
    two = threading.Event()

    def rec(pid, sig):
        got.append(sig)
        if len(got) >= 2:
            two.set()

    Chaos.parse("sigterm@step=2:again=0.01", kill=rec).step(2)
    assert got[0] == signal.SIGTERM
    assert two.wait(timeout=10.0), "second SIGTERM never fired"
    assert got == [signal.SIGTERM, signal.SIGTERM]


def test_chaos_install_reads_the_generation(monkeypatch):
    monkeypatch.setenv("TPUNET_ELASTIC_GENERATION", "3")
    got = chaos_mod.install("kill@step=1:gen=3", process_index=1)
    want = jax_chaos_mod.install("kill@step=1:gen=3", process_index=1)
    assert chaos_mod.current() is got
    assert (got.generation, got.process_index) == \
        (want.generation, want.process_index) == (3, 1)
    chaos_mod.clear()
    assert chaos_mod.current() is None


# ----------------------------------------------------------- rendezvous


def _rdzv_script(mod_rdzv, mod_quorum, d):
    """The same announce/gather/gone/heartbeat/join sequence; what each
    step returned."""
    out = []
    kw = dict(settle_s=0.05, timeout_s=5.0)
    a = mod_rdzv(os.path.join(d, "x"), "a", **kw)
    b = mod_rdzv(os.path.join(d, "x"), "b", **kw)
    c = mod_rdzv(os.path.join(d, "x"), "c", **kw)
    for r, port in ((b, 2), (a, 1), (c, 3)):
        r.announce(0, {"port": port, "ckpt_step": None})
    members = a.gather(0)
    out.append([(h, m["port"]) for h, m in members])
    out.append(a.latest_generation())
    c.mark_gone()
    out.append(sorted(a.members(0)))
    out.append(sorted(a.gone()))
    b.announce(2, {"port": 5})
    a.announce(2, {"port": 4})
    out.append([h for h, _ in b.gather(2)])
    out.append(a.latest_generation())
    a.heartbeat()
    b.heartbeat()
    out.append(sorted(a.stale_peers(["a", "b", "c", "ghost"], 60.0)))
    old = time.time() - 120.0
    os.utime(os.path.join(d, "x", "hb", "b"), (old, old))
    out.append(sorted(a.stale_peers(["a", "b"], 60.0)))
    b.request_join()
    c.request_join()           # gone hosts' requests are not listed
    out.append(sorted(a.join_requests()))
    a.clear_join("b")
    out.append(sorted(a.join_requests()))
    solo = mod_rdzv(os.path.join(d, "y"), "s", min_hosts=2,
                    settle_s=0.02, timeout_s=0.2)
    solo.announce(0, {})
    try:
        solo.gather(0)
    except mod_quorum as e:
        msg = str(e)
        out.append(msg[:msg.index("after")] + msg[msg.index("s,"):])
    for bad in ("", "a/b"):
        try:
            mod_rdzv(os.path.join(d, "z"), bad)
        except ValueError as e:
            out.append(str(e))
    try:
        mod_rdzv(os.path.join(d, "z"), "h", min_hosts=0)
    except ValueError as e:
        out.append(str(e))
    return out


def test_rendezvous_as_tpunets(tmp_path):
    got = _rdzv_script(Rendezvous, QuorumError, str(tmp_path / "port"))
    want = _rdzv_script(JaxRendezvous, JaxQuorumError, str(tmp_path / "ref"))
    assert got == want
    assert got[0] == [("a", 1), ("b", 2), ("c", 3)]
    assert "cannot form quorum" in got[-4]
    assert sorted(os.listdir(tmp_path / "port" / "x")) == \
        sorted(os.listdir(tmp_path / "ref" / "x"))


# --------------------------------------------------------------- events

RECORD_CASES = [
    dict(event="shrink", cause="host_lost", generation=2, old_world=2,
         new_world=1, hosts=["h0"], lost=["h1"], recovery_s=1.23456),
    dict(event="recovered", generation=1, new_world=1,
         old_mesh={"data": 2, "seq": 1, "pipe": 1, "model": 1},
         new_mesh={"data": 1, "seq": 1, "pipe": 1, "model": 1}, epoch=2,
         step=8),
    dict(event="quorum_failed", cause="cannot form quorum", generation=0),
    dict(event="evict", cause="step_stall", generation=0, old_world=2,
         new_world=1, lost=["h1"], detail={"reason": "step_stall"}),
    dict(event="evict_requested", cause="step_stall", epoch=2, step=10,
         detail={"step_time_s": 1.5}),
    dict(event="restart", cause="failed", generation=1, old_world=1,
         new_world=1, hosts=["h0"], lost=None, step=None, recovery_s=0.0),
    dict(event="grow", cause="join"),
]


@pytest.mark.parametrize("case", RECORD_CASES, ids=lambda c: c["event"])
def test_elastic_record_bodies_as_tpunets(case):
    kw = dict(case)
    event = kw.pop("event")
    assert events.build_elastic_record(event, **kw) == \
        jax_events.build_elastic_record(event, **kw)


def test_elastic_record_errors_and_severity_as_tpunets():
    with pytest.raises(ValueError) as got:
        events.build_elastic_record("explode")
    with pytest.raises(ValueError) as want:
        jax_events.build_elastic_record("explode")
    assert str(got.value) == str(want.value)
    assert events.EVENTS == jax_events.EVENTS
    assert events.ELASTIC_KIND == jax_events.ELASTIC_KIND
    assert events.build_elastic_record("quorum_failed")["severity"] == "fatal"


def _markers(mod, run_dir):
    out = []
    with open(os.path.join(run_dir, "run_id"), "w") as f:
        f.write("run-xyz\n")
    rec = mod.append_elastic_record(run_dir, mod.build_elastic_record(
        "shrink", cause="host_lost", generation=2, old_world=2,
        new_world=1, hosts=["h0"], lost=["h1"], recovery_s=1.25))
    out.append({k: v for k, v in rec.items() if k not in ("time", "host")})
    out.append([mod.is_done(run_dir), mod.read_evict_marker(run_dir)])
    mod.mark_done(run_dir)
    out.append(mod.is_done(run_dir))
    out.append(mod.write_evict_marker(run_dir, process_index=1, host="h1",
                                      reason="step_stall", detail={"x": 1}))
    out.append(mod.write_evict_marker(run_dir, process_index=0, host="h0",
                                      reason="step_stall"))
    marker = mod.read_evict_marker(run_dir)
    out.append({k: v for k, v in marker.items() if k != "time"})
    mod.clear_evict_marker(run_dir)
    out.append(mod.read_evict_marker(run_dir))
    mod.write_mesh(run_dir, {"data": 2, "seq": 1})
    out.append(mod.read_mesh(run_dir))
    mod.write_agent_state(run_dir, {"generation": 1, "world": 2})
    out.append(mod.read_agent_state(run_dir))
    out.append(sorted(os.listdir(os.path.join(run_dir, "elastic"))))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        out.append([sorted(json.loads(line)) for line in f])
    return out


def test_elastic_markers_as_tpunets(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert _markers(events, str(tmp_path / "a")) == \
        _markers(jax_events, str(tmp_path / "b"))


def test_agent_env_as_tpunets(monkeypatch):
    for env in ({}, {"TPUNET_ELASTIC_GENERATION": "2",
                     "TPUNET_ELASTIC_WORLD": "3", "TPUNET_ELASTIC_RANK": "1"},
                {"TPUNET_ELASTIC_GENERATION": "x"},
                {"TPUNET_ELASTIC_GENERATION": "0",
                 "TPUNET_ELASTIC_HOST": "h9"}):
        for key in ("TPUNET_ELASTIC_GENERATION", "TPUNET_ELASTIC_WORLD",
                    "TPUNET_ELASTIC_RANK", "TPUNET_ELASTIC_HOST"):
            monkeypatch.delenv(key, raising=False)
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        assert events.agent_env() == jax_events.agent_env()
        assert events.agent_host() == jax_events.agent_host()


# ------------------------------------------------------- agent (stubs)

DONE_CHILD = """
import os, sys
d = os.path.join([a for a in sys.argv[1:] if a != "--resume"][-1],
                 "elastic")
os.makedirs(d, exist_ok=True)
open(os.path.join(d, "done"), "w").write("x")
"""

ARGV_CHILD = """
import json, os, sys
run = [a for a in sys.argv[1:] if a != "--resume"][-1]
with open(os.path.join(run, "argv.json"), "w") as f:
    json.dump(sys.argv[1:], f)
d = os.path.join(run, "elastic")
os.makedirs(d, exist_ok=True)
open(os.path.join(d, "done"), "w").write("x")
"""

FAIL_CHILD = "import sys; sys.exit(1)"

# Fails in generation 0 (after writing a run id), finishes in 1.
FLAKY_CHILD = """
import json, os, sys
run = [a for a in sys.argv[1:] if a != "--resume"][-1]
gen = int(os.environ["TPUNET_ELASTIC_GENERATION"])
with open(os.path.join(run, f"argv{gen}.json"), "w") as f:
    json.dump(sys.argv[1:], f)
open(os.path.join(run, "run_id"), "w").write("r1\\n")
if gen == 0:
    sys.exit(3)
d = os.path.join(run, "elastic")
os.makedirs(d, exist_ok=True)
open(os.path.join(d, "done"), "w").write("x")
"""


# Claims the evict marker for its own host and stops (exit 0).
EVICT_CHILD = """
import json, os, sys
d = os.path.join([a for a in sys.argv[1:] if a != "--resume"][-1],
                 "elastic")
os.makedirs(d, exist_ok=True)
with open(os.path.join(d, "evict.json"), "w") as f:
    json.dump({"process_index": 0, "host": os.environ["TPUNET_ELASTIC_HOST"],
               "reason": "step_stall", "detail": {"step": 3}}, f)
"""


def _run_agent(mod_cfg, mod_agent, base, body, prep=None, host="h0", **kw):
    run_dir = os.path.join(base, "run")
    os.makedirs(run_dir, exist_ok=True)
    if prep is not None:
        prep(run_dir)
    cfg = mod_cfg(run_dir=run_dir, rdzv_dir=os.path.join(base, "rdzv"),
                  host_id=host, command=[sys.executable, "-c", body, run_dir],
                  settle_s=0.05, timeout_s=kw.pop("timeout_s", 5.0),
                  beat_s=0.05, grace_s=1.0, **kw)
    agent = mod_agent(cfg)
    agent._log = lambda *a, **k: None
    rc = agent.run()
    records = []
    path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            records = [{k: v for k, v in json.loads(line).items()
                        if k not in ("time", "host", "recovery_s")}
                       for line in f]
    argv = {}
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("argv"):
            with open(os.path.join(run_dir, name)) as f:
                argv[name] = [a for a in json.load(f) if a != run_dir]
    gone = sorted(agent.rdzv.gone())
    markers = os.path.join(run_dir, "elastic")
    return rc, records, argv, gone, (sorted(os.listdir(markers))
                                     if os.path.isdir(markers) else None)


def _with_run_id(run_dir):
    with open(os.path.join(run_dir, "run_id"), "w") as f:
        f.write("abc\n")


AGENT_CASES = {
    "done": dict(body=DONE_CHILD),
    "restart_then_gone": dict(body=FAIL_CHILD, max_restarts=1),
    "no_budget": dict(body=FAIL_CHILD, max_restarts=0),
    "quorum_failure": dict(body=DONE_CHILD, min_hosts=2, timeout_s=0.3),
    "fresh_no_resume": dict(body=ARGV_CHILD),
    "resume_once_run_id": dict(body=ARGV_CHILD, prep=_with_run_id),
    "restart_resumes": dict(body=FLAKY_CHILD, max_restarts=1),
    "evicted": dict(body=EVICT_CHILD),
}


@pytest.mark.parametrize("case", sorted(AGENT_CASES))
def test_agent_supervises_as_tpunets(tmp_path, case):
    kw = dict(AGENT_CASES[case])
    got = _run_agent(AgentConfig, ElasticAgent, str(tmp_path / "port"),
                     **kw)
    want = _run_agent(JaxAgentConfig, JaxElasticAgent,
                      str(tmp_path / "ref"), **kw)
    assert got == want
    rc, records, argv, gone, _ = got
    assert rc == {"done": EXIT_DONE, "restart_then_gone": EXIT_RESTARTS,
                  "no_budget": EXIT_RESTARTS, "quorum_failure": EXIT_QUORUM,
                  "fresh_no_resume": EXIT_DONE,
                  "resume_once_run_id": EXIT_DONE,
                  "restart_resumes": EXIT_DONE, "evicted": EXIT_DONE}[case]
    if case == "restart_then_gone":
        assert [r["event"] for r in records] == ["restart"]
        assert records[0]["cause"] == "failed" and gone == ["h0"]
    if case == "quorum_failure":
        assert [r["event"] for r in records] == ["quorum_failed"]
        assert records[0]["severity"] == "fatal"
    if case == "fresh_no_resume":
        assert "--resume" not in argv["argv.json"]
    if case == "resume_once_run_id":
        assert argv["argv.json"].count("--resume") == 1
    if case == "evicted":
        assert [r["event"] for r in records] == ["evict"]
        assert records[0]["lost"] == ["h0"] and gone == ["h0"]
    if case == "restart_resumes":
        assert "--resume" not in argv["argv0.json"]
        assert argv["argv1.json"].count("--resume") == 1
        assert records[0]["run_id"] == "r1"


ENV_CHILD = """
import json, os, sys
run = [a for a in sys.argv[1:] if a != "--resume"][-1]
keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
        "TPUNET_ELASTIC_GENERATION", "TPUNET_ELASTIC_WORLD",
        "TPUNET_ELASTIC_RANK", "TPUNET_ELASTIC_HOST", "CUDA_VISIBLE_DEVICES",
        "PINNED")
host = os.environ["TPUNET_ELASTIC_HOST"]
with open(os.path.join(run, f"env_{host}.json"), "w") as f:
    json.dump({k: os.environ.get(k) for k in keys}, f)
d = os.path.join(run, "elastic")
os.makedirs(d, exist_ok=True)
open(os.path.join(d, "done"), "w").write("x")
"""


def test_agent_gives_the_child_the_launchers_world(tmp_path, monkeypatch):
    """At world 2 the child gets RANK, WORLD_SIZE, LOCAL_RANK 0 and the
    first member's MASTER_ADDR/PORT; at world 1 none of the launcher's
    variables (an inherited one is removed); AgentConfig.env pins a
    card and removes variables."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    monkeypatch.setenv("MASTER_ADDR", "10.9.9.9")   # inherited: replaced
    cmd = [sys.executable, "-c", ENV_CHILD, run_dir]
    rcs = {}

    def agent(host, env):
        cfg = AgentConfig(run_dir=run_dir, rdzv_dir=str(tmp_path / "rdzv"),
                          host_id=host, command=cmd, settle_s=0.3,
                          timeout_s=20.0, beat_s=0.05, grace_s=1.0,
                          env=env)
        a = ElasticAgent(cfg)
        a._log = lambda *x, **k: None
        rcs[host] = a.run()

    threads = [threading.Thread(target=agent, args=(
        h, {"CUDA_VISIBLE_DEVICES": str(i), "PINNED": None}))
        for i, h in enumerate(("h0", "h1"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert rcs == {"h0": EXIT_DONE, "h1": EXIT_DONE}
    with open(os.path.join(run_dir, "elastic", "state.json")) as f:
        state = json.load(f)
    assert state["world"] == 2 and state["hosts"] == ["h0", "h1"]
    envs = {}
    for h in ("h0", "h1"):
        with open(os.path.join(run_dir, f"env_{h}.json")) as f:
            envs[h] = json.load(f)
    for r, h in enumerate(("h0", "h1")):
        e = envs[h]
        assert (e["RANK"], e["WORLD_SIZE"], e["LOCAL_RANK"]) == \
            (str(r), "2", "0")
        assert e["MASTER_ADDR"] == "127.0.0.1" and int(e["MASTER_PORT"]) > 0
        assert e["MASTER_PORT"] == envs["h0"]["MASTER_PORT"]
        assert (e["TPUNET_ELASTIC_GENERATION"], e["TPUNET_ELASTIC_WORLD"],
                e["TPUNET_ELASTIC_RANK"], e["TPUNET_ELASTIC_HOST"]) == \
            ("0", "2", str(r), h)
        assert e["CUDA_VISIBLE_DEVICES"] == str(r) and e["PINNED"] is None

    solo = ElasticAgent(AgentConfig(run_dir=run_dir, rdzv_dir="unused",
                                    host_id="h0", command=cmd))
    for key in LAUNCHER_VARS:
        monkeypatch.setenv(key, "stale")
    env = solo._child_env(3, 1, 0, "127.0.0.1:1234")
    assert not [k for k in LAUNCHER_VARS if k in env]
    assert env["TPUNET_ELASTIC_WORLD"] == "1"


def test_agent_reads_the_committed_step_not_a_torn_write(tmp_path):
    from tpunet_torch import ckpt
    assert STATE_META == ckpt.STATE_META
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    agent = ElasticAgent(AgentConfig(run_dir=str(run_dir),
                                     rdzv_dir=str(tmp_path / "rdzv"),
                                     host_id="h0", command=["true"]))
    assert agent._latest_ckpt_step() is None
    (run_dir / "state.pt.abc.part").write_bytes(b"torn")
    assert agent._latest_ckpt_step() is None
    (run_dir / STATE_META).write_text(json.dumps({"step": 3}))
    assert agent._latest_ckpt_step() == 3


# ------------------------------------------------------------------ CLI

BLOCK_TORCH = """
import runpy, sys
class Block:
    def find_spec(self, name, *a):
        if name.split('.')[0] in ('torch', 'numpy', 'jax', 'tpunet'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
sys.argv = ['x'] + sys.argv[1:]
runpy.run_module('tpunet_torch.elastic', run_name='__main__')
"""


def test_agent_cli_runs_with_torch_unimportable(tmp_path):
    help_out = subprocess.run(
        [sys.executable, "-c", BLOCK_TORCH, "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=60)
    assert help_out.returncode == 0, help_out.stderr
    assert "python -m tpunet_torch.elastic" in help_out.stdout
    from tpunet.elastic.__main__ import build_argparser as jax_parser
    from tpunet_torch.elastic.__main__ import build_argparser
    assert [a.dest for a in build_argparser()._actions] == \
        [a.dest for a in jax_parser()._actions]
    run_dir = tmp_path / "run"
    out = subprocess.run(
        [sys.executable, "-c", BLOCK_TORCH, "--run-dir", str(run_dir),
         "--rdzv-dir", str(tmp_path / "rdzv"), "--host-id", "h0",
         "--settle-s", "0.05", "--", sys.executable, "-c", DONE_CHILD,
         str(run_dir)], cwd=ROOT, capture_output=True, text=True,
        timeout=60)
    assert out.returncode == EXIT_DONE, out.stderr
    assert "training complete" in out.stdout
    usage = subprocess.run(
        [sys.executable, "-c", BLOCK_TORCH, "--run-dir", "r", "--rdzv-dir",
         "z"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert usage.returncode == 2
    assert "trainer command required" in usage.stderr


PEER_EVICT_CHILD = """
import json, os, sys, time
run = [a for a in sys.argv[1:] if a != "--resume"][-1]
host = os.environ["TPUNET_ELASTIC_HOST"]
gen = int(os.environ["TPUNET_ELASTIC_GENERATION"])
d = os.path.join(run, "elastic")
os.makedirs(d, exist_ok=True)
if host == "h1":
    # Evicted (its watchdog claimed), but slow to stop.
    with open(os.path.join(d, "evict.json"), "w") as f:
        json.dump({"process_index": 1, "host": "h1",
                   "reason": "step_stall", "detail": {}}, f)
    time.sleep(3)
elif gen == 0:
    time.sleep(0.5)          # h0 stops first: a clean stop, the next gen
else:
    open(os.path.join(d, "done"), "w").write("x")
"""


def test_evicted_host_leaves_when_a_peer_announces_first(tmp_path):
    """The evicted host's child is still stopping when the survivor
    announces the next generation: its agent takes the peer path, reads
    the marker there and leaves (tpunet's agent reads it only after its
    child exited, so it rejoined the pod when the survivor's rank 0 had
    cleared the marker first); rank 0 clears the marker once the evicted
    host is gone."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    cmd = [sys.executable, "-c", PEER_EVICT_CHILD, run_dir]
    rcs = {}

    def agent(host):
        a = ElasticAgent(AgentConfig(
            run_dir=run_dir, rdzv_dir=str(tmp_path / "rdzv"), host_id=host,
            command=cmd, settle_s=0.3, timeout_s=20.0, beat_s=0.05,
            grace_s=5.0))
        a._log = lambda *x, **k: None
        rcs[host] = a.run()

    threads = [threading.Thread(target=agent, args=(h,)) for h in ("h0", "h1")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert rcs == {"h0": EXIT_DONE, "h1": EXIT_DONE}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evicts = [r for r in records if r["event"] == "evict"]
    assert len(evicts) == 1 and evicts[0]["lost"] == ["h1"]
    changes = [r for r in records if r["event"] in ("shrink", "restart")]
    assert [(r["event"], r["new_world"]) for r in changes] == \
        [("shrink", 1)] or [(r["event"], r["new_world"])
                            for r in changes] == [("restart", 1)]
    with open(os.path.join(run_dir, "elastic", "state.json")) as f:
        assert json.load(f)["hosts"] == ["h0"]


# The evicted host (h1) claims the marker and stops at once; the
# survivor's generation-0 child is still running when h1's agent marks
# h1 gone, so the survivor's agent takes the peer path (host_left:h1).
GONE_FIRST_CHILD = """
import json, os, sys, time
run = [a for a in sys.argv[1:] if a != "--resume"][-1]
host = os.environ["TPUNET_ELASTIC_HOST"]
gen = int(os.environ["TPUNET_ELASTIC_GENERATION"])
d = os.path.join(run, "elastic")
os.makedirs(d, exist_ok=True)
if host == "h1":
    with open(os.path.join(d, "evict.json"), "w") as f:
        json.dump({"process_index": 1, "host": "h1",
                   "reason": "step_stall", "detail": {}}, f)
elif gen == 0:
    time.sleep(30)           # stopped by its agent on the peer path
else:
    open(os.path.join(d, "done"), "w").write("x")
"""


def test_survivor_records_evict_when_the_evicted_host_left_first(tmp_path):
    """The evicted host's gone marker is set before the survivor's child
    exits: the survivor's agent sees ``host_left:h1`` first, and its
    ``shrink`` record still says ``evict``, as the exit path's would."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    cmd = [sys.executable, "-c", GONE_FIRST_CHILD, run_dir]
    rcs, logs = {}, []

    def agent(host):
        a = ElasticAgent(AgentConfig(
            run_dir=run_dir, rdzv_dir=str(tmp_path / "rdzv"), host_id=host,
            command=cmd, settle_s=0.3, timeout_s=20.0, beat_s=0.05,
            grace_s=2.0))
        a._log = lambda msg, **k: logs.append(msg)
        rcs[host] = a.run()

    threads = [threading.Thread(target=agent, args=(h,)) for h in ("h0", "h1")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert rcs == {"h0": EXIT_DONE, "h1": EXIT_DONE}
    assert any("cause=evict" in m for m in logs), logs
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evicts = [r for r in records if r["event"] == "evict"]
    assert len(evicts) == 1 and evicts[0]["lost"] == ["h1"]
    shrinks = [r for r in records if r["event"] == "shrink"]
    assert len(shrinks) == 1, records
    assert shrinks[0]["cause"] == "evict"
    assert (shrinks[0]["old_world"], shrinks[0]["new_world"]) == (2, 1)
    assert shrinks[0]["lost"] == ["h1"]
    assert events.read_evict_marker(run_dir) is None


# Sleeps in generation 0 (its agent stops it on the peer path), finishes
# in the next one.
PEER_PATH_CHILD = """
import os, sys, time
run = [a for a in sys.argv[1:] if a != "--resume"][-1]
if int(os.environ["TPUNET_ELASTIC_GENERATION"]) == 0:
    time.sleep(30)
d = os.path.join(run, "elastic")
os.makedirs(d, exist_ok=True)
open(os.path.join(d, "done"), "w").write("x")
"""


@pytest.mark.parametrize("named", ["this_host", "peer", "none"])
def test_peer_path_reads_the_evict_marker(tmp_path, named):
    """The first supervise verdict is ``("peer", "host_left:h1")``. A
    marker naming this host leaves through ``_leave_evicted``; one naming
    the peer gives the next generation's record cause ``evict``; with no
    marker the cause is the verdict's, ``host_left``."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    if named != "none":
        events.write_evict_marker(
            run_dir, process_index=0, host="h0" if named == "this_host"
            else "h1", reason="step_stall", detail={"step": 3})
    a = ElasticAgent(AgentConfig(
        run_dir=run_dir, rdzv_dir=str(tmp_path / "rdzv"), host_id="h0",
        command=[sys.executable, "-c", PEER_PATH_CHILD, run_dir],
        settle_s=0.05, timeout_s=5.0, beat_s=0.05, grace_s=2.0))
    a._log = lambda *x, **k: None
    supervise, left = a._supervise, []
    verdicts = iter([("peer", "host_left:h1")])

    def first_peer(child, generation, hosts):
        return next(verdicts, None) or supervise(child, generation, hosts)

    def leave(evict, generation, world):
        left.append(evict["host"])
        return ElasticAgent._leave_evicted(a, evict, generation, world)

    a._supervise, a._leave_evicted = first_peer, leave
    assert a.run() == EXIT_DONE
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if named == "this_host":
        assert left == ["h0"] and sorted(a.rdzv.gone()) == ["h0"]
        assert [(r["event"], r["lost"]) for r in records] == \
            [("evict", ["h0"])]
    else:
        assert left == []
        assert [(r["event"], r["cause"]) for r in records] == \
            [("restart", "evict" if named == "peer" else "host_left")]
