"""The port's SLO engine (``tpunet_torch.obs.slo``) against tpunet's
(``tpunet.obs.slo``): the same seeded event streams and policies, fed
through both on a fake clock, give equal ``obs_slo`` records (verdicts,
burn rates, budgets, latches) and equal ``obs_alert`` pages; the same
malformed policies fail with the same message; and the port's prober
keeps the reference's warm-up gate and golden-mismatch path.
"""

import dataclasses
import json
import os
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tpunet.obs import slo as jax_slo
from tpunet.obs.registry import MemorySink as JaxMemorySink
from tpunet.obs.registry import Registry as JaxRegistry
from tpunet_torch.obs import slo
from tpunet_torch.obs.registry import MemorySink, Registry
import _torch_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

AVAIL = {"name": "availability", "sli": "availability", "objective": 0.9,
         "compliance_window_s": 1000,
         "page": {"long_s": 100, "short_s": 20, "burn": 2.0},
         "ticket": {"long_s": 400, "short_s": 50, "burn": 1.0}}
TTFT = {"name": "ttft", "sli": "latency_ttft", "objective": 0.9,
        "threshold_s": 0.5, "compliance_window_s": 600,
        "page": {"long_s": 60, "short_s": 10, "burn": 2.0}}
E2E = {"name": "e2e", "sli": "latency_e2e", "objective": 0.95,
       "threshold_s": 1.0, "compliance_window_s": 600,
       "ticket": {"long_s": 120, "short_s": 30, "burn": 1.0}}
CORRECT = {"name": "correctness", "sli": "correctness", "objective": 0.99,
           "compliance_window_s": 1000,
           "page": {"long_s": 60, "short_s": 10, "burn": 1.0}}

POLICIES = {
    "availability": {"slos": [AVAIL]},
    "latency": {"slos": [TTFT, E2E]},
    "correctness": {"slos": [CORRECT]},
    "all": {"slos": [AVAIL, TTFT, E2E, CORRECT]},
}


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _policy_file(tmp_path, policy) -> str:
    path = tmp_path / "policy.json"
    path.write_text("// a full-line comment\n" + json.dumps(policy))
    return str(path)


def _engines(specs_file):
    """(clock, [(engine, sink)] for tpunet then the port) on one clock."""
    clock = FakeClock()
    out = []
    for mod, reg_cls, sink_cls in ((jax_slo, JaxRegistry, JaxMemorySink),
                                   (slo, Registry, MemorySink)):
        registry = reg_cls()
        sink = sink_cls()
        registry.add_sink(sink)
        engine = mod.SloEngine(mod.load_policy(specs_file),
                               registry=registry, clock=clock)
        out.append((engine, registry, sink))
    return clock, out


def _event_stream(seed: int, n: int = 400):
    """Seeded SLI events: (dt, kind, args). Error rates drift in phases
    (healthy, burst, recovery, relapse) so pages and tickets fire,
    clear and re-fire."""
    rng = np.random.default_rng(seed)
    phases = rng.permutation([0.02, 0.6, 0.05, 0.3])
    events = []
    for i in range(n):
        p_bad = float(phases[min(i * len(phases) // n, len(phases) - 1)])
        dt = float(rng.exponential(0.8))
        kind = int(rng.integers(0, 4))
        bad = bool(rng.random() < p_bad)
        if kind == 0:
            events.append((dt, "request", (not bad,)))
        elif kind == 1:
            events.append((dt, "latency",
                           ("ttft", float(rng.exponential(0.25))
                            * (4.0 if bad else 1.0))))
        elif kind == 2:
            events.append((dt, "latency",
                           ("e2e", float(rng.exponential(0.5))
                            * (4.0 if bad else 1.0))))
        else:
            failed = bool(rng.random() < p_bad / 2)
            events.append((dt, "probe", dict(
                ok=not failed, mismatch=bad and not failed,
                ttft_s=float(rng.exponential(0.2)),
                e2e_s=float(rng.exponential(0.6)),
                trace_id=f"{i:016x}")))
    # One event stamped ahead of the evaluation clock (clock skew).
    events.append((0.0, "skewed", (3600.0,)))
    return events


def _feed(engine, clock, kind, args):
    if kind == "request":
        engine.note_request(*args, t=clock.t)
    elif kind == "latency":
        engine.note_latency(*args, t=clock.t)
    elif kind == "probe":
        engine.note_probe(**args, t=clock.t)
    else:
        engine.note_request(False, t=clock.t + args[0])


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_streams_give_equal_verdicts_and_pages(tmp_path, policy, seed):
    clock, pair = _engines(_policy_file(tmp_path, POLICIES[policy]))
    evaluated = [[], []]
    for step, (dt, kind, args) in enumerate(_event_stream(seed)):
        clock.t += dt
        for (engine, _, _), out in zip(pair, evaluated):
            _feed(engine, clock, kind, args)
            if step % 3 == 0:
                out.append(engine.evaluate())
    # A silence long enough to empty every alert window: the latches
    # hold in both.
    clock.t += 2000.0
    for (engine, _, _), out in zip(pair, evaluated):
        out.append(engine.evaluate())
    assert evaluated[1] == evaluated[0]
    (jax_engine, jax_reg, jax_sink), (engine, reg, sink) = pair
    assert sink.records == jax_sink.records
    assert reg.snapshot() == jax_reg.snapshot()
    for attr in ("probe_requests", "probe_failures", "probe_mismatches",
                 "last_failed_trace"):
        assert getattr(engine, attr) == getattr(jax_engine, attr)
    # The streams are long enough to exercise the latch in both.
    if policy in ("availability", "all"):
        assert any(r.get("kind") == "obs_alert" for r in sink.records)


def test_default_policy_and_docs_slos_json_load_alike():
    docs = os.path.join(REPO, "docs", "slos.json")
    for path in ("", docs):
        assert [dataclasses.asdict(s) for s in slo.load_policy(path)] == \
            [dataclasses.asdict(s) for s in jax_slo.load_policy(path)]
    assert slo.DEFAULT_POLICY == jax_slo.DEFAULT_POLICY


@pytest.mark.parametrize("mutate", [
    lambda s: s.update(name="Bad-Name"),
    lambda s: s.update(sli="uptime"),
    lambda s: s.update(objective=1.0),
    lambda s: s.update(objective="high"),
    lambda s: s.update(compliance_window_s=0),
    lambda s: (s.pop("page"), s.pop("ticket")),
    lambda s: s["page"].update(short_s=500),
    lambda s: s["page"].update(burn=0),
    lambda s: (s.update(sli="latency_ttft"), s.pop("threshold_s", None)),
])
def test_malformed_policies_fail_alike(tmp_path, mutate):
    spec = json.loads(json.dumps(AVAIL))
    mutate(spec)
    path = _policy_file(tmp_path, {"slos": [spec]})
    with pytest.raises(jax_slo.SloPolicyError) as ref:
        jax_slo.load_policy(path)
    with pytest.raises(slo.SloPolicyError) as got:
        slo.load_policy(path)
    assert str(got.value) == str(ref.value)


def test_duplicate_names_and_bad_json_fail_alike(tmp_path):
    path = tmp_path / "p.json"
    for text in (json.dumps({"slos": [AVAIL, AVAIL]}), "{", "{}"):
        path.write_text(text)
        with pytest.raises(jax_slo.SloPolicyError) as ref:
            jax_slo.load_policy(str(path))
        with pytest.raises(slo.SloPolicyError) as got:
            slo.load_policy(str(path))
        assert str(got.value) == str(ref.value)
    # A JSON array is refused as a policy error too (tpunet's loader
    # raises AttributeError there, past the router CLI's exit 2).
    path.write_text("[]")
    with pytest.raises(slo.SloPolicyError, match="non-empty 'slos'"):
        slo.load_policy(str(path))


def test_build_slo_record_equal():
    kw = dict(name="x", sli="availability", objective=0.99,
              compliance_window_s=60.0, events=10, bad=1, error_rate=0.1,
              budget_remaining=0.5, page_burn_long=1.2, page_burn_short=3.4,
              page_burn_threshold=14.4, page_window_long_s=3600.0,
              page_window_short_s=300.0, page_firing=True, pages_total=2,
              probe_requests=5, probe_failures=1, probe_mismatches=0,
              last_failed_trace="ab" * 8)
    assert slo.build_slo_record(**kw) == jax_slo.build_slo_record(**kw)
    lean = dict(name="x", sli="availability", objective=0.99,
                compliance_window_s=60.0)
    assert slo.build_slo_record(**lean) == jax_slo.build_slo_record(**lean)


class _StubEndpoint:
    """Minimal /v1/generate stream endpoint with mutable behavior."""

    def __init__(self):
        self.mode = "ok"          # ok | wrong | refuse
        self.tokens = [1, 2, 3, 4]
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # noqa: D102
                pass

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                if stub.mode == "refuse":
                    self.send_response(503)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                toks = (list(stub.tokens) if stub.mode == "ok"
                        else [9] * len(stub.tokens))
                lines = [json.dumps({"token": t, "i": i}).encode()
                         + b"\n" for i, t in enumerate(toks)]
                lines.append(json.dumps(
                    {"done": True, "finish_reason": "length",
                     "n_tokens": len(toks)}).encode() + b"\n")
                body = b"".join(lines)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_prober_warmup_gate_and_golden_mismatch(tmp_path):
    """The port's prober: boot-window failures (before a golden exists)
    do not feed the engine; the first clean probe arms it; wrong tokens
    after that are a mismatch; post-arm failures burn."""
    from tpunet_torch.router.prober import PROBE_NEW_TOKENS, PROBE_PROMPT
    from tpunet_torch.router.prober import Prober
    from tpunet.router import prober as jax_prober

    assert (PROBE_PROMPT, PROBE_NEW_TOKENS) == (
        jax_prober.PROBE_PROMPT, jax_prober.PROBE_NEW_TOKENS)
    clock = FakeClock()
    engine = slo.SloEngine(
        slo.load_policy(_policy_file(
            tmp_path, {"slos": [AVAIL, CORRECT]})),
        registry=None, clock=clock)
    registry = Registry()
    stub = _StubEndpoint()
    cfg = types.SimpleNamespace(probe_every_s=0.01, probe_timeout_s=2.0)
    prober = Prober(cfg, engine, registry=registry, base_url=stub.url)
    try:
        stub.mode = "refuse"           # fleet not up yet
        assert prober.probe_once() is False
        assert engine.probe_requests == 0
        assert registry.snapshot()["prober_failures_total"] == 1

        stub.mode = "ok"               # first clean probe arms it
        assert prober.probe_once() is True
        assert prober.golden == [1, 2, 3, 4]
        assert engine.probe_requests == 1

        stub.mode = "wrong"            # golden mismatch
        assert prober.probe_once() is True
        assert engine.probe_mismatches == 1
        assert registry.snapshot()["prober_mismatch_total"] == 1
        assert engine.last_failed_trace == prober.last_trace_id

        stub.mode = "refuse"           # post-arm failure burns
        assert prober.probe_once() is False
        assert engine.probe_failures == 1
        assert engine.probe_requests == 3
    finally:
        stub.close()
