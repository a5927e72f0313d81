"""Mid-stream failover through the port's router (``tpunet_torch.router``):
the router tests of tests/test_failover.py with the port's router, its
request journal and supervisor, and port replicas, without
``--aot-cache`` (refused by the port).

Cheapest first: the journal (against tpunet's on the same operations)
and its deadline budget, the supervisor's scoped ``--chaos``; the
stub-replica cases of the reference (the stdlib stand-ins of
scripts/serve_chaos_smoke.py play the replicas: duplicate suppression at
the seam, the journal cap's honest error frame, ``X-Deadline-Ms``
propagation and expiry, a drain during a failover); a resume from a
verified-only journal of a speculating port engine; and the end-to-end
test: two ``python -m tpunet_torch.serve --device cpu`` children with
``--chaos kill@tokens=12:replica=0``, a real SIGKILL after first bytes
reached the client, the stream held to the port's ``generate`` (greedy)
and to an uninterrupted port engine (sampled), with one trace id across
both replicas, and the timeline join of the port's ``obs/history``: one
causal track across the router and both replicas, the trace equal to
the one tpunet's ``build_timeline`` makes of the same run dirs.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpunet.router import journal as jax_journal
from tpunet_torch.config import ModelConfig, RouterConfig, ServeConfig
from tpunet_torch.router import journal
from tpunet_torch.router.journal import JournalEntry, RequestJournal
import _torch_threads  # noqa: E402,F401

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


def _smoke():
    """scripts/serve_chaos_smoke.py: its stub replicas and stream helpers
    are stdlib only (its own router legs import tpunet's router)."""
    sys.path.insert(0, SCRIPTS)
    try:
        return __import__("serve_chaos_smoke")
    finally:
        sys.path.pop(0)


def _wait(pred, timeout=20.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out: {what}")


# ---------------------------------------------------------------------------
# journal + supervisor (no processes)
# ---------------------------------------------------------------------------


def _journal_ops(mod):
    """The reference test's operations on one package's journal; returns
    the states it passes through."""
    jrn = mod.RequestJournal(max_tokens=3)
    entry = jrn.open({"tokens": [1], "max_new_tokens": 8}, deadline_t=None)
    states = [(jrn.active(), jrn.active_failovers())]
    states.append([jrn.note_token(entry, t) for t in (5, 6, 7, 8)])
    states.append((entry.over_cap, list(entry.tokens)))
    states.append(entry.resume_body())
    states.append(entry.body.get("resume_tokens"))
    jrn.begin_failover(entry)
    states.append((entry.failover_count, jrn.active_failovers(),
                   entry.tokens_relayed))
    jrn.end_failover(entry)
    states.append(jrn.active_failovers())
    jrn.close(entry)
    jrn.close(entry)                          # idempotent
    states.append(jrn.active())
    return states


def test_journal_roundtrip_cap_and_failover_accounting():
    states = _journal_ops(journal)
    assert states == _journal_ops(jax_journal)
    assert states[0] == (1, 0)
    assert states[1] == [True, True, True, False]   # cap: NOT recorded
    assert states[2] == (True, [5, 6, 7])
    assert states[3] == {"tokens": [1], "max_new_tokens": 8,
                         "resume_tokens": [5, 6, 7], "stream": True}
    assert states[4] is None                       # original intact
    assert states[5] == (1, 1, 3) and states[6] == 0 and states[7] == 0
    with pytest.raises(ValueError):
        RequestJournal(max_tokens=0)


def test_journal_entry_deadline_budget():
    entry = JournalEntry({}, deadline_t=time.monotonic() + 1.0)
    assert 0 < entry.remaining_ms() <= 1000
    assert JournalEntry({}).remaining_ms() is None
    expired = JournalEntry({}, deadline_t=time.monotonic() - 0.1)
    assert expired.remaining_ms() <= 0
    now = time.monotonic()
    ref = jax_journal.JournalEntry({}, deadline_t=now + 2.0)
    ours = JournalEntry({}, deadline_t=now + 2.0)
    assert ours.remaining_ms(now) == ref.remaining_ms(now) == 2000.0


def test_supervisor_forwards_scoped_chaos():
    from tpunet.router.supervisor import Supervisor as JaxSupervisor
    from tpunet_torch.router.supervisor import Supervisor
    chaos = "kill@tokens=5:replica=0;slow-stream@ms=9"
    sup = Supervisor(["--slots", "2"], chaos=chaos)
    ref = JaxSupervisor(["--slots", "2"], chaos=chaos)
    argv0 = sup.child_argv(0, 8001, "r-0")
    argv1 = sup.child_argv(1, 8002, "r-1")
    assert argv0[argv0.index("--chaos") + 1] == \
        "kill@tokens=5;slow-stream@ms=9"
    assert argv1[argv1.index("--chaos") + 1] == "slow-stream@ms=9"
    assert argv1[3:] == ref.child_argv(1, 8002, "r-1")[3:]
    # Caller-pinned --chaos in serve_args wins (not duplicated).
    sup2 = Supervisor(["--chaos", "kill@prefill"], chaos="kill@tokens=5")
    assert sup2.child_argv(0, 1, "x").count("--chaos") == 1
    # Unscoped-empty: no flag at all.
    sup3 = Supervisor([], chaos="kill@tokens=5:replica=3")
    assert "--chaos" not in sup3.child_argv(0, 1, "x")


# ---------------------------------------------------------------------------
# stub-replica integration (stdlib stubs, the port's router)
# ---------------------------------------------------------------------------


def _stub_fleet(behaviors, **cfg_kw):
    from tpunet_torch.router import Router, RouterServer
    smoke = _smoke()
    stubs = [smoke.StubReplica(f"fs{i}", b) for i, b in enumerate(behaviors)]
    cfg_kw.setdefault("probe_interval_s", 0.1)
    cfg_kw.setdefault("probe_timeout_s", 0.5)
    cfg_kw.setdefault("unhealthy_after", 2)
    cfg_kw.setdefault("boot_timeout_s", 2.0)
    cfg_kw.setdefault("emit_every_s", 0.0)
    cfg_kw.setdefault("affinity_prefix", 0)
    router = Router(RouterConfig(**cfg_kw), replica_urls=[s.url
                                                          for s in stubs])
    server = RouterServer(router, port=0).start()
    smoke.wait_for(lambda: router.healthy_count() == len(stubs),
                   what="stubs healthy")
    return smoke, stubs, router, server


def test_duplicate_token_seam_suppressed():
    """The dying replica re-emits its last token at the seam and the
    resumed stream is index-stamped: the client sees every index
    exactly once, identical to an uninterrupted stream."""
    smoke, stubs, router, server = _stub_fleet(
        [{"die_after_tokens": 4, "dup_at_seam": True}, {}])
    try:
        lines = smoke.read_stream(
            f"http://127.0.0.1:{server.port}",
            {"tokens": [10], "max_new_tokens": 10, "stream": True})
        toks = [ev["token"] for ev in lines if "token" in ev]
        assert toks == smoke.expected_tokens(10, 10)
        assert [ev["i"] for ev in lines if "token" in ev] == list(range(10))
        done = lines[-1]
        assert done["finish_reason"] == "length" and "error" not in done
        assert done["failover_count"] == 1
        assert stubs[1].resumes == 1
    finally:
        server.drain()
        for s in stubs:
            s.close()


def test_journal_cap_honest_error_frame():
    """Past the cap, replica death degrades to the honest error frame,
    never a silent truncation or a wrong resume."""
    smoke, stubs, router, server = _stub_fleet(
        [{"die_after_tokens": 6}, {}], failover_journal_tokens=3)
    try:
        lines = smoke.read_stream(
            f"http://127.0.0.1:{server.port}",
            {"tokens": [9], "max_new_tokens": 12, "stream": True})
        done = lines[-1]
        assert done["finish_reason"] == "error"
        assert "journal cap" in done["error"]
        assert done["n_tokens"] == 3     # what the journal still holds
        assert stubs[1].resumes == 0
    finally:
        server.drain()
        for s in stubs:
            s.close()


def test_deadline_header_propagates_and_expires():
    """X-Deadline-Ms is forwarded with the remaining budget; an expired
    budget is a 504 with the partial count; garbage is a 400."""
    smoke, stubs, router, server = _stub_fleet([{}, {}])
    base = f"http://127.0.0.1:{server.port}"
    try:
        lines = smoke.read_stream(
            base, {"tokens": [5], "max_new_tokens": 4, "stream": True},
            headers=[("X-Deadline-Ms", "30000")])
        assert lines[-1]["finish_reason"] == "length"
        seen = [h for s in stubs for h in s.headers_seen
                if "X-Deadline-Ms" in h]
        assert seen and all(0 < float(h["X-Deadline-Ms"]) <= 30000
                            for h in seen)
        before = sum(s.requests for s in stubs)
        for deadline, code, payload in (
                ("0.001", 504, {"error": "deadline", "n_tokens": 0}),
                ("soon", 400, None)):
            req = urllib.request.Request(
                base + "/v1/generate",
                json.dumps({"tokens": [5], "stream": True}).encode(),
                {"Content-Type": "application/json",
                 "X-Deadline-Ms": deadline})
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=10)
            assert exc.value.code == code
            if payload is not None:
                assert json.loads(exc.value.read()) == payload
        assert sum(s.requests for s in stubs) == before
    finally:
        server.drain()
        for s in stubs:
            s.close()


def test_drain_waits_for_inflight_failover():
    """A drain during a failover waits (inside the shared grace budget)
    until the resume is re-homed; the client stream still completes
    with no error frame."""
    smoke, stubs, router, server = _stub_fleet(
        [{"die_after_tokens": 2},
         {"resume_delay_s": 1.0, "line_delay_s": 0.05}],
        drain_grace_s=15.0)
    result = {}

    def client():
        try:
            result["lines"] = smoke.read_stream(
                f"http://127.0.0.1:{server.port}",
                {"tokens": [3], "max_new_tokens": 8, "stream": True},
                timeout=30)
        except Exception as e:  # noqa: BLE001 — asserted below
            result["error"] = e

    t = threading.Thread(target=client)
    t.start()
    try:
        smoke.wait_for(lambda: router.journal.active_failovers() > 0,
                       timeout=10, what="failover to begin")
        server.drain()                  # must block past the window
        assert router.journal.active_failovers() == 0
        t.join(timeout=30)
        assert not t.is_alive()
        assert "error" not in result, result.get("error")
        lines = result["lines"]
        assert [ev["token"] for ev in lines if "token" in ev] == \
            smoke.expected_tokens(3, 8)
        done = lines[-1]
        assert done["finish_reason"] == "length" and "error" not in done
        assert done["failover_count"] == 1
    finally:
        for s in stubs:
            s.close()


# ---------------------------------------------------------------------------
# speculative decoding x failover: verified-only journal resume
# ---------------------------------------------------------------------------


def test_spec_midverify_stop_resumes_from_verified_journal():
    """A port spec replica stopped mid-verify-window leaves a journal of
    verified tokens only, and a survivor seeded with it continues the
    canonical stream, greedy and sampled (bitwise a spec-off run)."""
    from tpunet_torch.models import create_model
    from tpunet_torch.serve import Engine

    model = create_model(ModelConfig(
        name="lm", vit_hidden=32, vit_depth=2, vit_heads=2,
        dropout_rate=0.0, dtype="float32", vocab_size=31, max_seq_len=48),
        device="cpu", generator=torch.Generator().manual_seed(0))

    def make(spec):
        return Engine(model, ServeConfig(
            slots=2, queue_max=8, prefill_buckets=(8, 16),
            emit_every_s=0.0, spec_decode=spec, spec_k=3,
            spec_draft_width_mult=1.0)).start()

    prompt = np.random.default_rng(31).integers(0, 31, size=6).astype(
        np.int32)
    eng_off, eng_on = make(False), make(True)
    try:
        for samp in (dict(), dict(temperature=0.9, top_k=5, seed=77)):
            canonical = eng_off.submit(
                prompt, max_new_tokens=10, **samp).result(timeout=60)
            # K=3 self-spec emits 4 verified tokens a cycle; a budget of
            # 6 stops 2 tokens into the second verify window.
            journal = eng_on.submit(
                prompt, max_new_tokens=6, **samp).result(timeout=60)
            assert journal == canonical[:6], samp
            resumed = eng_on.submit(
                prompt, max_new_tokens=10, resume_tokens=journal,
                **samp).result(timeout=60)
            assert resumed == canonical, samp
    finally:
        eng_off.stop()
        eng_on.stop()


# ---------------------------------------------------------------------------
# end-to-end: a real SIGKILL mid-stream through real HTTP
# ---------------------------------------------------------------------------

LM_ARGS = ["--vit-hidden", "32", "--vit-depth", "2", "--vit-heads", "2",
           "--vocab-size", "256", "--max-seq-len", "256"]


def pin_session_to(name: str) -> str:
    """A session whose rendezvous-preferred replica over the supervised
    fleet's names r0/r1 is ``name``: routes the stream onto the
    chaos-armed child."""
    from tpunet_torch.router.balance import preferred_replica
    from tpunet_torch.router.replica import ReplicaHandle
    fakes = [ReplicaHandle("r0", "http://x"), ReplicaHandle("r1", "http://x")]
    return next(s for s in (f"sess{i}" for i in range(256))
                if preferred_replica(fakes, f"s:{s}").name == name)


def _stream(base, body, timeout=60, headers=()):
    req = urllib.request.Request(
        base + "/v1/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json", **dict(headers)})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return [json.loads(line) for line in resp]


def test_midstream_sigkill_failover_real_http(tmp_path, monkeypatch):
    """A chaos SIGKILL of the serving port replica after first bytes
    reached the client gives a whole client stream with no error frame:
    greedy token-identical to the port's ``generate``, sampled identical
    to an uninterrupted port engine, one trace id across the hops."""
    from tpunet_torch.infer.generate import load_lm
    from tpunet_torch.models.lm import generate
    from tpunet_torch.router.__main__ import build_argparser, build_server
    from tpunet_torch.serve import Engine

    _torch_threads.one_thread_children(monkeypatch)
    argv = ["--spawn", "2", "--port", "0", "--probe-interval-s", "0.2",
            "--probe-timeout-s", "2", "--unhealthy-after", "2",
            "--boot-timeout-s", "90", "--respawn-backoff-s", "0.2",
            "--emit-every-s", "0.5", "--min-replicas", "2",
            "--max-replicas", "2", "--metrics-dir", str(tmp_path),
            "--chaos", "kill@tokens=12:replica=0", "--",
            "--checkpoint-dir", "", "--device", "cpu", "--slots", "2",
            "--prefill-buckets", "64", "--queue-max", "16",
            "--max-new-tokens", "64"] + LM_ARGS
    server = build_server(build_argparser().parse_args(argv)).start()
    router = server.router
    base = f"http://127.0.0.1:{server.port}"
    session = pin_session_to("r0")
    model = load_lm(ModelConfig(name="lm", vit_hidden=32, vit_depth=2,
                                vit_heads=2, vocab_size=256,
                                max_seq_len=256, dropout_rate=0.0),
                    "", device="cpu")
    prompt = [17, 5, 211, 42, 9]
    trace_id = "abad1deafee1900d"   # client-supplied: always sampled
    try:
        _wait(lambda: router.healthy_count() == 2, timeout=90,
              what="both replicas healthy (cold boot)")
        assert all("--aot-cache" not in router.supervisor.child_argv(
            i, 1, "x") for i in (0, 1))

        # -- greedy: bitwise parity with an uninterrupted solo run ----
        lines = _stream(base, {"tokens": prompt, "max_new_tokens": 24,
                               "stream": True, "session": session},
                        headers=[("X-Trace-Id", trace_id)])
        done = lines[-1]
        assert done.get("done") and done["finish_reason"] == "length", done
        assert "error" not in done and done.get("failover_count", 0) >= 1
        solo = generate(model, torch.tensor([prompt]), 24)[
            0, len(prompt):].tolist()
        assert [ev["token"] for ev in lines if "token" in ev] == solo
        assert [ev["i"] for ev in lines if "token" in ev] == list(range(24))

        # -- sampled: deterministic continuation across the failover --
        # (the victim is evicted and respawned before it counts as
        # healthy again: its chaos re-arms with the new process)
        _wait(lambda: router.registry.snapshot().get(
            "router_respawns_total", 0) >= 1, timeout=30, what="respawn")
        _wait(lambda: router.healthy_count() == 2, timeout=90,
              what="victim respawned healthy")
        ref_engine = Engine(model, ServeConfig(
            slots=2, prefill_buckets=(64,), emit_every_s=0.0)).start()
        try:
            ref_tokens = ref_engine.submit(
                np.asarray(prompt, np.int32), max_new_tokens=24,
                temperature=0.9, seed=1234).result(timeout=60)
        finally:
            ref_engine.stop()
        lines = _stream(base, {"tokens": prompt, "max_new_tokens": 24,
                               "stream": True, "temperature": 0.9,
                               "seed": 1234, "session": session})
        done = lines[-1]
        assert done.get("done") and done["finish_reason"] == "length", done
        assert "error" not in done
        assert done.get("failover_count", 0) >= 1, \
            "respawned replica's re-armed chaos never fired"
        assert [ev["token"] for ev in lines if "token" in ev] == ref_tokens

        snap = json.loads(urllib.request.urlopen(
            base + "/metrics", timeout=10).read())
        assert snap["router_failovers_total"] >= 2
    finally:
        server.drain()
        for index in (0, 1):
            proc = router.supervisor.get(index)
            if proc is not None and proc.alive():
                proc.proc.kill()

    # -- failover events + counters in metrics.jsonl -------------------
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    events = [r for r in recs if r.get("kind") == "obs_router"
              and r.get("event") == "failover"]
    assert len(events) >= 2
    assert all(e["cause"] == "replica_failed_mid_stream" for e in events)
    windows = [r for r in recs if r.get("kind") == "obs_router"
               and not r.get("event")]
    assert windows[-1]["failovers_total"] >= 2

    # -- ONE trace_id spans both replicas ------------------------------
    spans = [r for r in recs if r.get("kind") == "obs_trace"
             and r.get("trace_id") == trace_id]
    assert len(spans) == 1 and spans[0]["role"] == "router", spans
    assert spans[0]["hop"] == 0 and spans[0]["finish_reason"] == "length"
    assert spans[0]["tokens"] == 24 and spans[0]["failover_count"] >= 1
    assert spans[0].get("tokens_relayed") is not None
    rep_spans = []
    for rep_dir in sorted(tmp_path.glob("replica-*")):
        mfile = rep_dir / "metrics.jsonl"
        if mfile.exists():
            rep_spans += [json.loads(line) for line
                          in mfile.read_text().splitlines()
                          if '"obs_trace"' in line]
    rep_spans = [r for r in rep_spans if r.get("trace_id") == trace_id]
    resumed = next(r for r in rep_spans if r.get("resume_offset"))
    assert resumed["role"] == "replica" and resumed["hop"] >= 2
    assert resumed["resume_offset"] + resumed["tokens"] == 24
    assert resumed["finish_reason"] == "length"

    # -- the timeline join renders one causal track --------------------
    from tpunet.obs.history.timeline import build_timeline as jax_timeline
    from tpunet_torch.obs.history.timeline import build_timeline
    dirs = [str(tmp_path)] + [str(d) for d
                              in sorted(tmp_path.glob("replica-*"))]
    trace = build_timeline(dirs)
    assert json.dumps(trace, sort_keys=True) == json.dumps(
        jax_timeline(dirs), sort_keys=True)
    joined = [e for e in trace["traceEvents"]
              if e.get("args", {}).get("trace_id") == trace_id
              and e["pid"] == 1]
    names = {e["name"] for e in joined}
    assert "relay" in names, "router relay span missing from the join"
    assert "seam" in names, "failover seam missing from the join"
    assert any(e.get("args", {}).get("force_closed") == "failover_seam"
               for e in joined), "first hop never force-closed"
    reps = {e["args"]["replica"] for e in joined
            if e.get("args", {}).get("replica")}
    assert len(reps) >= 2, f"trace does not span both replicas: {reps}"
    assert any(e.get("args", {}).get("process") for e in joined), \
        "no replica-side crumbs joined the track"
