"""The port's run history (``tpunet_torch.obs.history``: store, compare,
timeline) and its CLIs against tpunet's, on the CPU.

The fixtures of tests/test_obs_history.py go through both packages and
the outputs must be equal: run summaries, the history index on disk, the
bench join, every compare verdict, the fleet panel's regression rows and
the timeline's chrome-trace JSON (a synthetic ring, and the rings of a
port training run and a port serve engine). The port's ``python -m
tpunet_torch.obs.cli.compare`` and ``.timeline`` run in a subprocess
with JAX and tpunet unimportable, and print and write what the
reference's scripts print and write.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import tpunet.obs.history as jhist
import tpunet_torch.obs.history as phist
from tpunet.obs.agg import Aggregator as JaxAggregator
from tpunet.utils.logging import MetricsLogger as JaxMetricsLogger
from tpunet_torch.obs.agg import Aggregator
from tpunet_torch.utils.logging import MetricsLogger

import _torch_threads  # noqa: F401
from test_obs_history import RUN_A, RUN_B, _validate_chrome_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpunet")


def _records(run_dir):
    return MetricsLogger.read_records(os.path.join(run_dir, "metrics.jsonl"))


def _dump(x):
    return json.dumps(x, sort_keys=True)


def run_without_jax(module, argv, cwd=REPO):
    """``python -m module argv`` with JAX and tpunet unimportable."""
    code = ("import runpy, sys\n"
            f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
            f"sys.argv = [{module!r}] + {list(argv)!r}\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    sys.exit(e.code)\n")
    env = _torch_threads.child_env(PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def run_script(name, argv, cwd=REPO):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", name), *argv],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=_torch_threads.child_env(JAX_PLATFORMS="cpu"))


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", [RUN_A, RUN_B])
def test_summarize_run_equals_tpunet(run):
    got = phist.summarize_run(_records(run), source=run)
    want = jhist.summarize_run(JaxMetricsLogger.read_records(
        os.path.join(run, "metrics.jsonl")), source=run)
    assert _dump(got) == _dump(want)


def _history_files(d):
    return {name: open(os.path.join(d, name)).read()
            for name in sorted(os.listdir(d))}


def test_history_store_on_disk_equals_tpunet(tmp_path):
    """Ingest order A, B, A (latest wins), a bench artifact joined by run
    id and one by fingerprint alone: the index files and every view are
    equal."""
    bench = {"parsed": {"metric": "train_images_per_sec_per_chip",
                        "value": 5016.0, "unit": "img/s/chip",
                        "run_id": "runA", "config_fingerprint": "fixfp0001ab",
                        "device_kind": "NVIDIA H100 80GB HBM3"}}
    (tmp_path / "BENCH_r99.json").write_text(json.dumps(bench))
    bench["parsed"].pop("run_id")
    (tmp_path / "BENCH_r100.json").write_text(json.dumps(bench))
    views = {}
    for tag, mod in (("port", phist), ("ref", jhist)):
        h = mod.RunHistory(str(tmp_path / tag))
        for run in (RUN_A, RUN_B, RUN_A):
            h.ingest_run(run)
        for b in ("BENCH_r99.json", "BENCH_r100.json"):
            h.ingest_bench(str(tmp_path / b))
        views[tag] = dict(
            runs=h.runs(), entries=h.entries("run"),
            by_fp=h.runs(fingerprint="fixfp0001ab"),
            bench=h.bench_for(h.run("runA")),
            files=_history_files(str(tmp_path / tag)))
        with pytest.raises(FileNotFoundError):
            h.ingest_run(str(tmp_path / "empty"))
    assert _dump(views["port"]) == _dump(views["ref"])
    assert len(views["port"]["bench"]) == 2


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------


def _summaries(mod, mismatch=False):
    a = mod.summarize_run(_records(RUN_A), source=RUN_A)
    b = dict(mod.summarize_run(_records(RUN_B), source=RUN_B))
    if mismatch:
        b["config_fingerprint"] = "otherfp00000"
    return a, b


@pytest.mark.parametrize("case", ["identical", "regression", "reversed",
                                  "fingerprint_mismatch", "no_data"])
def test_compare_summaries_equals_tpunet(case):
    out = {}
    for tag, mod in (("port", phist), ("ref", jhist)):
        a, b = _summaries(mod, mismatch=case == "fingerprint_mismatch")
        pair = {"identical": (a, a), "regression": (a, b),
                "reversed": (b, a), "fingerprint_mismatch": (a, b),
                "no_data": ({"run_id": "x"}, {"run_id": "y"})}[case]
        out[tag] = mod.compare_summaries(*pair)
    assert _dump(out["port"]) == _dump(out["ref"])
    verdict = {"identical": "ok", "regression": "regression",
               "no_data": "incomparable"}.get(case)
    if verdict:
        assert out["port"]["verdict"] == verdict


@pytest.mark.parametrize("case", ["coarse", "dense", "saturated", "random"])
def test_quantile_verdict_equals_tpunet(case):
    rng = np.random.default_rng(17)
    if case == "coarse":
        a = [0.010 + 0.001 * i for i in range(8)]
        args = ([(a, 100, False)], [([v + 0.0004 for v in a], 100, False)])
    elif case == "dense":
        a = [0.010 + 0.00001 * i for i in range(256)]
        args = ([(a, 10000, False)],
                [([v + 0.0004 for v in a], 10000, False)])
    elif case == "saturated":
        a = [0.010 + 0.0001 * i for i in range(64)]
        args = ([(a, 10 ** 6, True)], [(a, 10 ** 6, True)])
    else:
        a = sorted(float(v) for v in rng.gamma(4.0, 0.003, 200))
        b = sorted(float(v) for v in rng.gamma(4.0, 0.0033, 150))
        c = sorted(float(v) for v in rng.gamma(4.0, 0.003, 90))
        args = ([(a, 400, False), (c, 90, False)], [(b, 1000, True)])
    for q in (50, 90, 99):
        assert _dump(phist.quantile_verdict(*args, q)) \
            == _dump(jhist.quantile_verdict(*args, q))


def test_stream_regressions_and_emit_equal_tpunet(tmp_path):
    """The fleet panel's rows from each package's Aggregator over runs A
    and B, and the ``obs_regression`` record each package emits."""
    rows = {}
    for tag, agg, mod in (("port", Aggregator(), phist),
                          ("ref", JaxAggregator(), jhist)):
        for rec in _records(RUN_A) + _records(RUN_B):
            agg.ingest(rec, stamp_time=False)
        rows[tag] = mod.stream_regressions(agg.streams())
    assert _dump(rows["port"]) == _dump(rows["ref"])
    assert rows["port"][0]["verdict"] == "regression"
    from tpunet.obs.registry import MemorySink as JaxMemorySink
    from tpunet.obs.registry import Registry as JaxRegistry
    from tpunet_torch.obs.registry import MemorySink, Registry
    emitted = {}
    for tag, mod, reg, sink in (("port", phist, Registry(), MemorySink()),
                                ("ref", jhist, JaxRegistry(),
                                 JaxMemorySink())):
        reg.add_sink(sink)
        a, b = _summaries(mod)
        mod.emit_regression(reg, mod.compare_summaries(a, b))
        emitted[tag] = [{k: v for k, v in r.items() if k != "time"}
                        for r in sink.by_kind("obs_regression")]
    assert emitted["port"] and _dump(emitted["port"]) == _dump(emitted["ref"])


# ---------------------------------------------------------------------------
# the compare CLI, on a host without JAX
# ---------------------------------------------------------------------------


def _alt_run(tmp_path):
    alt = tmp_path / "runC"
    alt.mkdir()
    with open(alt / "metrics.jsonl", "w") as f:
        for r in _records(RUN_B):
            f.write(json.dumps(dict(r, config_fingerprint="otherfp00000"))
                    + "\n")
    return str(alt)


@pytest.mark.parametrize("case", ["regression", "ok", "usage", "unknown_flag",
                                  "missing", "fp_refused", "fp_allowed",
                                  "json_emit"])
def test_compare_cli_equals_the_script(tmp_path, case):
    """Exit code, stdout and stderr of ``python -m
    tpunet_torch.obs.cli.compare`` with no JAX equal the script's (the
    emitted record file too)."""
    argv = {"regression": [RUN_A, RUN_B], "ok": [RUN_A, RUN_A],
            "usage": [RUN_A], "unknown_flag": [RUN_A, RUN_B, "--bogus"],
            "missing": [RUN_A, RUN_B + "-missing"],
            "fp_refused": [RUN_A, "ALT"],
            "fp_allowed": [RUN_A, "ALT", "--allow-fingerprint-mismatch"],
            "json_emit": [RUN_A, RUN_B, "--json", "--emit", "EMIT"]}[case]
    if "ALT" in argv:
        argv[argv.index("ALT")] = _alt_run(tmp_path)
    outs = {}
    for tag in ("port", "ref"):
        args = [str(tmp_path / f"{tag}.jsonl") if a == "EMIT" else a
                for a in argv]
        p = (run_without_jax("tpunet_torch.obs.cli.compare", args)
             if tag == "port" else run_script("obs_compare.py", args))
        outs[tag] = (p.returncode, p.stdout,
                     p.stderr.replace("obs_compare.py", "PROG"))
    assert outs["port"] == outs["ref"], outs["port"][2]
    rc = {"regression": 3, "ok": 0, "usage": 2, "unknown_flag": 2,
          "missing": 2, "fp_refused": 2, "fp_allowed": 3,
          "json_emit": 3}[case]
    assert outs["port"][0] == rc
    if case == "json_emit":
        strip = lambda rs: [{k: v for k, v in r.items()  # noqa: E731
                             if k != "time"} for r in rs]
        got, want = (strip(MetricsLogger.read_records(
            str(tmp_path / f"{t}.jsonl"))) for t in ("port", "ref"))
        assert len(got) == 1 and got[0]["kind"] == "obs_regression"
        assert _dump(got) == _dump(want)


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------


def _synthetic_ring(d):
    from tpunet_torch.obs.flightrec.ring import EventRing
    d.mkdir(parents=True)
    ring = EventRing(str(d / "events.ring"), 64)
    for kind, msg in (("span", "step 1"), ("span", "tpunet/data_wait"),
                      ("span_end", "tpunet/data_wait"),
                      ("span_end", "step 1"), ("thread", "busy ckpt-writer"),
                      ("thread", "idle ckpt-writer"),
                      ("req", "submit 7 len=5"), ("req", "prefill 7"),
                      ("req", "first_token 7"), ("req", "finish 7 length"),
                      ("alert", "step_stall step=9"),
                      ("span", "never closed")):
        ring.record(kind, msg)
    ring.close()


def test_timeline_of_a_synthetic_ring_equals_tpunet(tmp_path):
    _synthetic_ring(tmp_path / "run" / "flightrec")
    got = phist.build_timeline([str(tmp_path / "run")])
    _validate_chrome_trace(got)
    assert _dump(got) == _dump(jhist.build_timeline([str(tmp_path / "run")]))
    phases = {e["name"] for e in got["traceEvents"]
              if e["ph"] == "X" and e.get("args", {}).get("req")}
    assert phases == {"queue", "prefill", "decode"}
    with pytest.raises(FileNotFoundError):
        phist.build_timeline([str(tmp_path / "nothing")])


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """A 2-step port LM training run and a port serve engine that
    answered two requests, each with its flight recorder."""
    from tpunet_torch.config import ModelConfig, ServeConfig
    from tpunet_torch.infer.generate import load_lm
    from tpunet_torch.obs import flightrec
    from tpunet_torch.serve import Engine
    from tpunet_torch.train import __main__ as cli

    d = tmp_path_factory.mktemp("timeline")
    cli.run(["--preset", "serial", "--model", "lm", "--dataset",
             "synthetic_lm", "--vit-hidden", "32", "--vit-depth", "2",
             "--vit-heads", "2", "--vocab-size", "32", "--seq-len", "32",
             "--batch-size", "16", "--synthetic-size", "32", "--dtype",
             "float32", "--epochs", "1", "--device", "cpu",
             "--obs-step-every", "1", "--checkpoint-dir", str(d / "train")])
    rec = flightrec.install(str(d / "serve"), watcher=False, native=False)
    try:
        model = load_lm(ModelConfig(name="lm", vit_hidden=32, vit_depth=2,
                                    vit_heads=2, dropout_rate=0.0,
                                    vocab_size=31, max_seq_len=48), "",
                        device="cpu")
        eng = Engine(model, ServeConfig(
            slots=2, queue_max=4, prefill_buckets=(8,),
            default_max_new_tokens=4, emit_every_s=0.0)).start()
        try:
            reqs = [eng.submit(np.array([1, 2, 3], np.int32),
                               max_new_tokens=3) for _ in range(2)]
            for r in reqs:
                r.result(timeout=60)
        finally:
            eng.stop()
    finally:
        flightrec.close(rec)
    return d


def test_timeline_of_port_runs_equals_tpunet(port_runs):
    dirs = [str(port_runs / "train"), str(port_runs / "serve")]
    got = phist.build_timeline(dirs)
    _validate_chrome_trace(got)
    assert _dump(got) == _dump(jhist.build_timeline(dirs))
    events = got["traceEvents"]
    assert any(e["ph"] == "B" for e in events)
    assert any(e["ph"] == "X" and e["name"] == "busy" for e in events)
    assert any(e.get("args", {}).get("finish_reason") for e in events
               if e["ph"] == "X" and e.get("args", {}).get("req"))
    assert len({e["pid"] for e in events}) == 2


@pytest.mark.parametrize("case", ["two_runs", "metrics_dir", "no_ring",
                                  "usage"])
def test_timeline_cli_equals_the_script(port_runs, tmp_path, case):
    """``python -m tpunet_torch.obs.cli.timeline`` with no JAX: the exit
    code, the summary it prints and the trace file equal the script's."""
    train, serve = str(port_runs / "train"), str(port_runs / "serve")
    argv = {"two_runs": [train, serve, "-o", "OUT"],
            "metrics_dir": ["--metrics-dir", train, "--metrics-dir", serve,
                            "--out", "OUT"],
            "no_ring": [str(tmp_path), "-o", "OUT"],
            "usage": ["-o", "OUT"]}[case]
    outs = {}
    for tag in ("port", "ref"):
        out = str(tmp_path / f"{tag}.json")
        args = [out if a == "OUT" else a for a in argv]
        p = (run_without_jax("tpunet_torch.obs.cli.timeline", args)
             if tag == "port" else run_script("obs_timeline.py", args))
        text = (p.stdout + p.stderr).replace(out, "OUT").replace(
            "obs_timeline.py", "PROG")
        outs[tag] = (p.returncode, text,
                     open(out).read() if os.path.exists(out) else None)
    assert outs["port"] == outs["ref"], outs["port"][1]
    assert outs["port"][0] == {"two_runs": 0, "metrics_dir": 0,
                               "no_ring": 1, "usage": 2}[case]
    if outs["port"][2] is not None:
        _validate_chrome_trace(json.loads(outs["port"][2]))


def test_port_history_runs_under_torch_alone():
    """The history and aggregation packages import with JAX and tpunet
    unimportable (what the card's host has)."""
    code = ("import sys\n"
            f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
            "import tpunet_torch.obs.history as h, tpunet_torch.obs.agg as a\n"
            "import tpunet_torch.obs.cli.dashboard\n"
            "print(len(h.__all__), len(a.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=_torch_threads.child_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["11", "5"]
