"""The port's HTTP server (``tpunet_torch.serve.ServeServer``) and CLI on
the CPU: the endpoints and status codes of tests/test_serve_http.py,
``/v1/classify`` micro-batched against ``Predictor.predict_probs``, the
argparser round trip and its exit-2 refusals, two in-process port
replicas behind tpunet's reference router (``tpunet.router``'s
``Router`` + ``RouterServer``) with greedy parity through the proxy, and
the ``obs_serve`` records: every field documented in
docs/metrics_schema.md, and for the same registry state the keys of
tpunet's ``build_serve_record``.
"""

import importlib.util
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tpunet.config import RouterConfig
from tpunet.serve.engine import build_serve_record as jax_build_serve_record
from tpunet_torch.config import DataConfig, ModelConfig, ServeConfig
from tpunet_torch.infer.predict import Predictor
from tpunet_torch.models import create_model
from tpunet_torch.models.lm import generate
from tpunet_torch.obs.registry import JsonlSink, Registry
from tpunet_torch.serve import ClassifyBatcher, Engine, ServeServer
from tpunet_torch.serve.engine import build_serve_record
from tpunet_torch.utils.logging import MetricsLogger
import _torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TINY = ModelConfig(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2,
                   dropout_rate=0.0, dtype="float32", vocab_size=256,
                   max_seq_len=64)


@pytest.fixture(scope="module")
def lm():
    return create_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(0))


def make_server(lm, tmp_path=None, *, with_classifier=False, model=None,
                run_id="", **cfg_kw):
    cfg_kw.setdefault("slots", 2)
    cfg_kw.setdefault("queue_max", 4)
    cfg_kw.setdefault("prefill_buckets", (16,))
    cfg_kw.setdefault("default_max_new_tokens", 8)
    cfg_kw.setdefault("emit_every_s", 0.0)
    engine = Engine(model if model is not None else lm,
                    ServeConfig(**cfg_kw))
    metrics_logger = None
    if tmp_path is not None:
        metrics_logger = MetricsLogger(str(tmp_path))
        engine.registry.add_sink(JsonlSink(metrics_logger))
    batcher = None
    if with_classifier:
        pred = Predictor(ModelConfig(dtype="float32", width_mult=0.5,
                                     dropout_rate=0.0),
                         DataConfig(image_size=32), device="cpu")
        batcher = ClassifyBatcher(pred, batch_max=4, window_ms=5.0,
                                  registry=engine.registry)
    return ServeServer(engine, classify_batcher=batcher, port=0,
                       metrics_logger=metrics_logger, run_id=run_id).start()


def post(base, path, obj, timeout=120):
    req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(base, path, timeout=30):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def greedy(lm, tokens, n):
    return generate(lm, torch.tensor([tokens]), n)[0, len(tokens):].tolist()


def test_http_end_to_end(lm, tmp_path):
    """healthz, token and text generate with parity to generate,
    streaming, classify 503 (none configured), 400/413/404, metrics,
    drain -> the final obs_serve record in metrics.jsonl."""
    srv = make_server(lm, tmp_path)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, health = get(base, "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert health["slots"] == 2 and health["run_id"].startswith("serve-")
        code, out = post(base, "/v1/generate",
                         {"prompt": "hello", "max_new_tokens": 5})
        assert code == 200 and out["finish_reason"] == "length"
        assert out["tokens"] == greedy(lm, list(b"hello"), 5)
        assert isinstance(out["text"], str)
        assert out["ttft_ms"] > 0 and out["e2e_ms"] >= out["ttft_ms"]
        code, out2 = post(base, "/v1/generate",
                          {"tokens": list(b"hello"), "max_new_tokens": 5})
        assert code == 200 and out2["tokens"] == out["tokens"]
        req = urllib.request.Request(
            base + "/v1/generate",
            json.dumps({"prompt": "hi", "max_new_tokens": 4,
                        "stream": True}).encode(),
            {"Content-Type": "application/json",
             "X-Trace-Id": "abad1deafee1900d"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            assert "ndjson" in r.headers["Content-Type"]
            lines = [json.loads(line) for line in
                     r.read().decode().strip().splitlines()]
        assert [ev["i"] for ev in lines[:4]] == [0, 1, 2, 3]
        assert [ev["token"] for ev in lines[:4]] == greedy(lm, list(b"hi"), 4)
        assert lines[-1] == {**lines[-1], "done": True,
                             "finish_reason": "length", "n_tokens": 4}
        assert post(base, "/v1/generate", {})[0] == 400
        assert post(base, "/v1/generate", {"tokens": []})[0] == 400
        assert post(base, "/v1/generate", {"tokens": [999]})[0] == 400
        assert post(base, "/v1/generate", {"tokens": [1] * 40})[0] == 413
        assert post(base, "/v1/classify", {"image": [[0]]})[0] == 503
        assert get(base, "/nope")[0] == 404
        code, snap = get(base, "/metrics")
        assert code == 200 and snap["serve_requests_total"] >= 3
        assert snap["serve_tokens_total"] >= 14 and "serve_ttft_s_p50" in snap
    finally:
        srv.drain(timeout=30.0)
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    serve_recs = [r for r in recs if r.get("kind") == "obs_serve"]
    assert serve_recs[-1]["final"] and serve_recs[-1]["requests_total"] >= 3
    assert serve_recs[-1]["queue_depth"] == 0
    # the X-Trace-Id request closed its replica span
    traces = [r for r in recs if r.get("kind") == "obs_trace"]
    assert [t["trace_id"] for t in traces] == ["abad1deafee1900d"]
    assert traces[0]["role"] == "replica" and traces[0]["tokens"] == 4


def test_http_resume_tokens_continue_the_stream(lm):
    """A router failover re-submits with ``resume_tokens``: the stream
    continues at index len(resume_tokens) with the uninterrupted run's
    tokens."""
    srv = make_server(lm)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        want = greedy(lm, [5, 9, 2], 8)
        req = urllib.request.Request(
            base + "/v1/generate",
            json.dumps({"tokens": [5, 9, 2], "max_new_tokens": 8,
                        "resume_tokens": want[:3], "stream": True}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [json.loads(line) for line in r.read().decode()
                     .strip().splitlines()]
        assert [(ev["i"], ev["token"]) for ev in lines[:-1]] == \
            list(enumerate(want))[3:]
        assert lines[-1]["n_tokens"] == 8
    finally:
        srv.drain(timeout=30.0)


def test_http_queue_full_returns_429(lm):
    srv = make_server(lm, slots=1, queue_max=1, default_max_new_tokens=60)
    base = f"http://127.0.0.1:{srv.port}"
    real = srv.engine._step

    def slow(*a):
        time.sleep(0.02)
        return real(*a)

    srv.engine._step = slow
    try:
        threads = [threading.Thread(target=post, args=(
            base, "/v1/generate", {"prompt": "a", "max_new_tokens": 50}))
            for _ in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.1)
        got = None
        deadline = time.perf_counter() + 30
        while got is None and time.perf_counter() < deadline:
            code, out = post(base, "/v1/generate",
                             {"prompt": "b", "max_new_tokens": 50})
            got = out if code == 429 else None
        assert got is not None and got["error"] == "queue_full"
        for t in threads:
            t.join(timeout=300)
        assert get(base, "/metrics")[1]["serve_requests_rejected"] >= 1
    finally:
        srv.drain(timeout=30.0)


def test_http_classify_micro_batched(lm):
    srv = make_server(lm, with_classifier=True)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        rng = np.random.default_rng(0)
        imgs = [rng.integers(0, 256, (32, 32, 3)).astype(int).tolist()
                for _ in range(6)]
        results = [None] * 6

        def worker(i):
            results[i] = post(base, "/v1/classify",
                              {"image": imgs[i], "topk": 3})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        pred = srv.classify.predictor
        for img, (code, out) in zip(imgs, results):
            assert code == 200 and len(out["topk"]) == 3
            ref = pred.predict_probs(np.asarray(img, np.uint8))
            got = np.asarray([out["probs"][n] for n in pred.class_names])
            np.testing.assert_allclose(got, ref, atol=2e-5)
        snap = get(base, "/metrics")[1]
        assert snap["serve_classify_requests_total"] == 6
        assert snap["serve_classify_batches_total"] < 6
    finally:
        srv.drain(timeout=10.0)


def test_healthz_unhealthy_after_engine_crash(lm):
    srv = make_server(lm)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        def boom(*a):
            raise RuntimeError("step exploded")

        srv.engine._step = boom
        code, out = post(base, "/v1/generate", {"prompt": "x"})
        assert code in (500, 503)
        deadline = time.perf_counter() + 30
        code = 200
        while code == 200 and time.perf_counter() < deadline:
            code, health = get(base, "/healthz")
            time.sleep(0.05)
        assert code == 503 and health["status"] == "unhealthy"
        assert "step exploded" in health["error"]
    finally:
        srv.drain(timeout=10.0)


def test_drain_under_load_finishes_stream_and_503s_new_requests():
    """An in-flight ndjson stream completes (finish_reason length) while
    drain() runs; requests arriving during the drain get 503."""
    big = ModelConfig(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2,
                      dropout_rate=0.0, dtype="float32", vocab_size=256,
                      max_seq_len=512)
    model = create_model(big, device="cpu")
    srv = make_server(None, model=model, slots=1, drain_timeout_s=60.0,
                      default_max_new_tokens=300)
    base = f"http://127.0.0.1:{srv.port}"
    req = urllib.request.Request(
        base + "/v1/generate",
        json.dumps({"prompt": "hi", "max_new_tokens": 300,
                    "stream": True}).encode(),
        {"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=120)
    first = json.loads(resp.readline())
    assert "token" in first
    drained = []
    t = threading.Thread(target=lambda: drained.append(
        srv.drain(timeout=60.0)))
    t.start()
    deadline = time.perf_counter() + 30
    while not srv.engine.draining and time.perf_counter() < deadline:
        time.sleep(0.001)           # admissions close before the first try
    saw_503 = False
    while not saw_503 and time.perf_counter() < deadline:
        try:
            code, out = post(base, "/v1/generate",
                             {"prompt": "x", "max_new_tokens": 2}, timeout=30)
        except (urllib.error.URLError, OSError):
            break
        saw_503 = code == 503 and out["error"] == "draining"
    lines = [json.loads(line) for line in resp]
    resp.close()
    done = ([first] + lines)[-1]
    assert done.get("done") and done["finish_reason"] == "length"
    assert done["n_tokens"] == 300
    t.join(timeout=90)
    assert drained and drained[0], "drain did not finish clean"
    assert saw_503, "never observed a mid-drain 503 rejection"


def _probe_draining(base):
    """/healthz and /v1/generate both answer 503 "draining" with the
    drain budget as Retry-After."""
    for path, body in (("/healthz", None), ("/v1/generate",
                                            {"prompt": "x"})):
        data = None if body is None else json.dumps(body).encode()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                base + path, data), timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read())["error" if body else "status"] \
            == "draining"
        assert int(e.value.headers["Retry-After"]) == 45


def test_draining_503_carries_retry_after_header(lm):
    srv = make_server(lm, drain_timeout_s=45.0)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        srv.engine._draining.set()
        srv.engine.queue.close()
        # The idle loop may end (draining with no work) before or after
        # the probe: either way the engine is draining, not dead.
        _probe_draining(base)
    finally:
        srv.drain(timeout=10.0)


def test_draining_503_after_the_loop_ended(lm):
    """The same probes once the engine thread has ended through the drain
    path (no error): still 503 "draining" with Retry-After, never
    "unhealthy"."""
    srv = make_server(lm, drain_timeout_s=45.0)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        srv.engine._draining.set()
        srv.engine.queue.close()
        srv.engine._wake.set()
        srv.engine._thread.join(timeout=30)
        assert not srv.engine._thread.is_alive()
        assert srv.engine.error is None and srv.engine.healthy
        _probe_draining(base)
    finally:
        srv.drain(timeout=10.0)


def test_serve_cli_argparser_roundtrip_and_refusals(capsys):
    from tpunet_torch.serve.__main__ import (build_argparser, build_server,
                                             parse_prefill_buckets)

    args = build_argparser().parse_args(
        ["--checkpoint-dir", "ck", "--slots", "3", "--queue-max", "5",
         "--prefill-buckets", "8,32", "--port", "0",
         "--vit-hidden", "32", "--vit-depth", "2", "--vit-heads", "2",
         "--max-seq-len", "64"])
    assert (args.slots, args.queue_max, args.prefill_buckets) == (3, 5, "8,32")
    assert args.device == "cuda" and args.vit_hidden == 32
    assert parse_prefill_buckets("8, 32", 64) == (8, 32)
    for bad in ("", "8,x", "0", "128"):
        with pytest.raises(SystemExit) as e:
            parse_prefill_buckets(bad, 64)
        assert e.value.code == 2
    base = ["--checkpoint-dir", "", "--device", "cpu", "--max-seq-len", "64",
            "--prefill-buckets", "16"]
    # --mesh-model is ported: the default 3 heads do not split over 2
    # ranks (tpunet's message), and 4 heads need torchrun's processes.
    for extra, item in ((["--mesh-model", "2"], "--vit-heads 3 not "
                         "divisible by the mesh 'model' axis (2)"),
                        (["--model", "lm_pp", "--mesh-model", "2"],
                         "--vit-heads 3 not divisible"),
                        (["--model", "lm_pp", "--moe-experts", "4",
                          "--mesh-model", "2", "--vit-hidden", "32",
                          "--vit-heads", "4"], "torchrun"),
                        (["--aot-cache", "d"], "out of scope"),
                        (["--chaos", "boom@tokens=1"], "unknown kind")):
        with pytest.raises(SystemExit) as e:
            build_server(build_argparser().parse_args(base + extra))
        assert e.value.code == 2
        assert item in capsys.readouterr().err
    tiny = base + ["--vit-hidden", "32", "--vit-depth", "2",
                   "--vit-heads", "2"]
    # Queue A item 5's flags are live: each builds its engine.
    store = ROOT / "build" / "tpunet_torch" / "test_cli_prefix_store"
    for extra, check in (
            (["--kv-dtype", "int8"],
             lambda eng: eng._paged_kv.quantized),
            (["--spec-decode", "--spec-k", "3"],
             lambda eng: eng.spec_k == 3 and eng._drafter is not None),
            (["--prefix-store", str(store)],
             lambda eng: eng._prefix_store.directory == str(store)),
            (["--chaos", "kill@tokens=1"],
             lambda eng: eng.chaos.render() == "kill@tokens=1")):
        srv = build_server(build_argparser().parse_args(
            tiny + extra + ["--port", "0"])).start()
        try:
            assert check(srv.engine), extra
        finally:
            srv.drain(timeout=5.0)
    # The exporters are ported: --statsd builds a statsd exporter on the
    # registry, and a malformed --obs-http or --obs-webhook URL fails at
    # setup, as tpunet's serve CLI does.
    srv = build_server(build_argparser().parse_args(
        tiny + ["--statsd", "127.0.0.1:1"])).start()
    try:
        assert [e.name for e in srv._exporters] == ["statsd"]
        assert srv._exporters[0] in srv.registry._sinks
    finally:
        srv.drain(timeout=5.0)
    for extra, match in ((["--obs-http", "u"], "--obs-http"),
                         (["--obs-webhook", "u"], "webhook")):
        with pytest.raises(ValueError, match=match):
            build_server(build_argparser().parse_args(tiny + extra))


def test_two_port_replicas_behind_the_reference_router(lm):
    """tpunet's router fronts two port replicas (same weights): greedy
    tokens through the proxy, sync and streamed, equal generate's."""
    from tpunet.router import Router, RouterServer

    replicas = [make_server(lm, queue_max=8, run_id=f"port-{i}")
                for i in range(2)]
    cfg = RouterConfig(probe_interval_s=0.1, emit_every_s=0.0)
    router = Router(cfg, replica_urls=[f"http://127.0.0.1:{r.port}"
                                       for r in replicas])
    server = RouterServer(router, port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        deadline = time.monotonic() + 30
        while router.healthy_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.healthy_count() == 2
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 256, int(n)).tolist()
                   for n in rng.integers(3, 12, 6)]
        outs = [None] * len(prompts)

        def client(i):
            outs[i] = post(base, "/v1/generate",
                           {"tokens": prompts[i], "max_new_tokens": 6,
                            "session": f"s{i}"})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for p, (code, out) in zip(prompts, outs):
            assert code == 200 and out["tokens"] == greedy(lm, p, 6)
        req = urllib.request.Request(
            base + "/v1/generate",
            json.dumps({"tokens": prompts[0], "max_new_tokens": 6,
                        "stream": True}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [json.loads(line) for line in r.read().decode()
                     .strip().splitlines()]
        assert [ev["token"] for ev in lines if "token" in ev] == \
            greedy(lm, prompts[0], 6)
        assert lines[-1]["done"] and lines[-1]["finish_reason"] == "length"
        assert {h.run_id for h in router.replicas} == {"port-0", "port-1"}
        assert sum(r.registry.counter("serve_requests_total").value
                   for r in replicas) == len(prompts) + 1
    finally:
        server.drain()
        for r in replicas:
            r.drain(timeout=10.0)


def _schema():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", ROOT / "scripts" / "check_metrics_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _registry_state(reg):
    """One registry state with every serve_* instrument touched."""
    for name, n in (("serve_requests_total", 5), ("serve_requests_completed",
                                                  3),
                    ("serve_requests_rejected", 1), ("serve_tokens_total", 40),
                    ("serve_decode_steps_total", 12), ("serve_prefills_total",
                                                       4),
                    ("serve_prefix_lookups_total", 4),
                    ("serve_prefix_hits_total", 1),
                    ("serve_prefix_hit_tokens_total", 16)):
        reg.counter(name).inc(n)
    for name in ("serve_ttft_s", "serve_token_s", "serve_e2e_s",
                 "serve_prefill_s"):
        for v in (0.01, 0.02, 0.05):
            reg.histogram(name).observe(v)
    reg.gauge("serve_kv_pages_total").set(10)
    reg.gauge("serve_kv_pages_used").set(3)
    reg.gauge("serve_kv_bytes_per_token").set(512.0)
    reg.gauge("serve_prefix_pages_cached").set(2)


def test_obs_serve_records_follow_the_schema(lm):
    """Every field of the port's obs_serve (and obs_trace) records is
    documented in docs/metrics_schema.md, and build_serve_record gives
    tpunet's keys and values for the same registry state."""
    from tpunet.obs.registry import Registry as JaxRegistry

    ours, theirs = Registry(), JaxRegistry()
    _registry_state(ours)
    _registry_state(theirs)
    kw = dict(queue_depth=1, active_slots=2, slots=4, uptime_s=3.0,
              window_s=1.5, final=True)
    rec = build_serve_record(ours, **kw)
    assert rec == jax_build_serve_record(theirs, **kw)
    # an engine's own records, through a drained server
    srv = make_server(lm)
    records = []
    srv.engine.registry.add_sink(type("S", (), {
        "write": lambda self, r: records.append(r)})())
    base = f"http://127.0.0.1:{srv.port}"
    urllib.request.urlopen(urllib.request.Request(
        base + "/v1/generate", json.dumps({"prompt": "ab"}).encode(),
        {"X-Trace-Id": "0123456789abcdef"}), timeout=60).read()
    srv.drain(timeout=10.0)
    schema = _schema()
    kinds, fields, global_fields = schema.parse_schema()
    assert {r["kind"] for r in records} == {"obs_serve", "obs_trace"}
    assert schema.undocumented(records, kinds, fields, global_fields) == []
