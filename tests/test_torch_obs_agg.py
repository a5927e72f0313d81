"""The port's fleet aggregation (``tpunet_torch.obs.agg``) and its
dashboard CLI against tpunet's, on the CPU.

The record fixtures of tests/test_obs_agg.py and
tests/test_obs_dashboard.py go through both packages and the outputs must
be equal: the percentile merge and its rank-error bounds, the fleet
rollups, the alerts and the records the sinks receive in every alert
scenario, and the dashboard's terminal frames and HTML (single run and
fleet). ``python -m tpunet_torch.obs.cli.dashboard --once`` runs in a
subprocess with JAX and tpunet unimportable, and prints and writes what
``scripts/obs_dashboard.py`` prints and writes.
"""

import json
import os
import random
import re
import threading

import pytest

import tpunet.obs.agg as jagg
import tpunet_torch.obs.agg as pagg
from tpunet.obs.agg import merge as jmerge
from tpunet.obs.registry import MemorySink as JaxMemorySink
from tpunet.obs.summary import summarize as jax_summarize
from tpunet_torch.obs.agg import merge as pmerge
from tpunet_torch.obs.cli import dashboard as pdash
from tpunet_torch.obs.registry import Histogram, MemorySink
from tpunet_torch.obs.summary import summarize
from tpunet_torch.utils.logging import MetricsLogger

import _torch_threads  # noqa: F401
from test_obs_agg import (_epoch_record, _import_dashboard, _serve_record,
                          _two_stream_records, _write_stream_files)
from test_obs_dashboard import _write_run
from test_torch_obs_history import run_script, run_without_jax


def _dump(x):
    return json.dumps(x, sort_keys=True)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "time"} for r in records]


# ---------------------------------------------------------------------------
# merge math
# ---------------------------------------------------------------------------


def _lossy_parts(seed, sizes=(4000, 1000), max_samples=512):
    rng = random.Random(seed)
    parts = []
    for n, base, spread in zip(sizes, (0.010, 0.050, 0.02),
                               (0.002, 0.010, 0.05)):
        h = Histogram(max_samples=max_samples)
        for _ in range(n):
            h.observe(base + rng.random() * spread)
        parts.append((h.export_sample(), n, h.saturated))
    return parts


@pytest.mark.parametrize("seed,sizes,max_samples", [
    (42, (4000, 1000), 512), (7, (200,), 100_000), (3, (60, 700, 5), 64)])
def test_merge_equals_tpunet(seed, sizes, max_samples):
    parts = _lossy_parts(seed, sizes, max_samples)
    qs = (1, 50, 90, 99, 100)
    assert pmerge.merged_quantiles(parts, qs) \
        == jmerge.merged_quantiles(parts, qs)
    assert pmerge.rank_error_bound(parts) == jmerge.rank_error_bound(parts)
    means = [(sum(s) / len(s), n) for s, n, _ in parts]
    assert pmerge.merged_mean(means) == jmerge.merged_mean(means)
    for k in (1, 16, 256, 4096):
        for sat in (False, True):
            assert pmerge.part_rank_error(k, sat) \
                == jmerge.part_rank_error(k, sat)
        assert pmerge.dkw_epsilon(k) == jmerge.dkw_epsilon(k)
    recs = [_epoch_record("a", ep, [0.01 * ep] * 30) for ep in (1, 2, 3)]
    assert pmerge.record_parts(recs, "step_time_sample", "steps") \
        == jmerge.record_parts(recs, "step_time_sample", "steps")


# ---------------------------------------------------------------------------
# the aggregator: rollups and alerts
# ---------------------------------------------------------------------------


def _scenario(mod, sink, name):
    """Feed ``name``'s records to ``mod``'s Aggregator; return it."""
    clock = [100.0]
    if name == "two_streams":
        agg = mod.Aggregator(straggler_factor=2.0)
        agg.registry.add_sink(sink)
        for recs in _two_stream_records().values():
            agg.ingest_many(recs, stamp_time=False)
        agg.emit_rollup()
    elif name == "latch":
        agg = mod.Aggregator(straggler_factor=2.0)
        agg.registry.add_sink(sink)
        agg.ingest_many([_epoch_record("a", 1, [0.01] * 20),
                         _epoch_record("b", 1, [0.08] * 20)],
                        stamp_time=False)
        agg.emit_rollup()
        agg.emit_rollup()
        for ep, lap in ((2, 0.011), (3, 0.09)):
            agg.ingest(_epoch_record("b", ep, [lap] * 20), stamp_time=False)
            agg.emit_rollup()
    elif name == "stale":
        agg = mod.Aggregator(clock=lambda: clock[0], stream_stale_s=30.0)
        agg.registry.add_sink(sink)
        agg.ingest(_epoch_record("a", 1, [0.01] * 5))
        agg.ingest(_epoch_record("b", 1, [0.01] * 5))
        agg.emit_rollup()
        clock[0] += 31.0
        agg.ingest(_epoch_record("a", 2, [0.01] * 5))
        agg.emit_rollup()
    elif name == "mem_growth":
        agg = mod.Aggregator(mem_growth_bytes_per_epoch=10_000.0)
        agg.registry.add_sink(sink)
        for ep in range(1, 6):
            agg.ingest(_epoch_record("flat", ep, [0.01] * 5, peak=2 ** 30),
                       stamp_time=False)
            agg.ingest(_epoch_record("leaky", ep, [0.01] * 5,
                                     peak=2 ** 30 + ep * 10 ** 6),
                       stamp_time=False)
        agg.emit_rollup()
    elif name == "rules":
        agg = mod.Aggregator(rules=("serve_queue_depth > 5",))
        agg.registry.add_sink(sink)
        agg.ingest(_serve_record("r1", queue=2), stamp_time=False)
        agg.ingest(_serve_record("r2", queue=4), stamp_time=False)
        agg.emit_rollup()
    elif name == "handoff":
        agg = mod.Aggregator(straggler_factor=2.0)
        agg.registry.add_sink(sink)
        for run, lap in (("a", 0.01), ("b", 0.08), ("c", 0.012)):
            agg.ingest(_epoch_record(run, 1, [lap] * 20), stamp_time=False)
        agg.emit_rollup()
        agg.ingest(_epoch_record("b", 2, [0.011] * 20), stamp_time=False)
        agg.ingest(_epoch_record("c", 2, [0.09] * 20), stamp_time=False)
        agg.emit_rollup()
    elif name == "mixed_units":
        agg = mod.Aggregator()
        agg.registry.add_sink(sink)
        agg.ingest(_epoch_record("lm", 1, [0.01] * 10, unit="tokens",
                                 thr=5000.0), stamp_time=False)
        agg.ingest(_epoch_record("img", 1, [0.01] * 10, unit="examples",
                                 thr=300.0), stamp_time=False)
        agg.emit_rollup()
    else:                                  # sources and their streams
        agg = mod.Aggregator()
        agg.registry.add_sink(sink)
        agg.ingest({"kind": "obs_step", "step": 1, "step_time_s": 0.01},
                   source="old-a.jsonl")
        agg.ingest(_epoch_record("a", 1, [0.01] * 5), source="a.jsonl")
        agg.ingest(_epoch_record("b", 1, [0.01] * 5), source="b.jsonl")
        agg.drop_source("a.jsonl")
        agg.emit_rollup()
    return agg


@pytest.mark.parametrize("name", ["two_streams", "latch", "stale",
                                  "mem_growth", "rules", "handoff",
                                  "mixed_units", "sources"])
def test_aggregator_equals_tpunet(name):
    """Rollup, alerts and every record the sinks received are equal."""
    got = _scenario(pagg, MemorySink(), name)
    want = _scenario(jagg, JaxMemorySink(), name)
    assert _dump(got.rollup()) == _dump(want.rollup())
    assert _dump(_strip(got.bridge.alerts)) \
        == _dump(_strip(want.bridge.alerts))
    assert [s.key for s in got.streams()] == [s.key for s in want.streams()]
    psink = [s for s in got.registry._sinks if isinstance(s, MemorySink)][0]
    jsink = [s for s in want.registry._sinks
             if isinstance(s, JaxMemorySink)][0]
    assert _dump(_strip(psink.records)) == _dump(_strip(jsink.records))
    if name in ("two_streams", "latch", "stale", "mem_growth", "handoff"):
        assert got.bridge.alerts


def test_concurrent_ingest_equals_tpunet_replay(tmp_path):
    """Two streams ingested from two threads into the port's Aggregator
    give tpunet's rollup of the same files replayed offline."""
    by_stream = _two_stream_records()
    live = pagg.Aggregator(straggler_factor=2.0)
    threads = [threading.Thread(target=lambda recs=recs: live.ingest_many(
        recs)) for recs in by_stream.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    replay = jagg.Aggregator(straggler_factor=2.0)
    for path in _write_stream_files(tmp_path):
        replay.replay_file(path)
    assert _dump(live.rollup()) == _dump(replay.rollup())


def test_bad_rules_refused_as_tpunet_refuses():
    from tpunet.obs.health import GaugePredicate as JaxGaugePredicate
    from tpunet_torch.obs.health import GaugePredicate
    for bad in ("what is this", "mfu > 1e", "x + ../s", "y < +-3"):
        with pytest.raises(ValueError) as got:
            pagg.Aggregator(rules=(bad,))
        with pytest.raises(ValueError) as want:
            jagg.Aggregator(rules=(bad,))
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="bad gauge rule"):
            GaugePredicate.parse(bad)
        with pytest.raises(ValueError, match="bad gauge rule"):
            JaxGaugePredicate.parse(bad)


# ---------------------------------------------------------------------------
# the dashboard
# ---------------------------------------------------------------------------


def test_dashboard_renderers_equal_the_script(tmp_path):
    """The single-run frame and HTML of one summary, and the fleet frame
    and HTML of one rollup, are equal."""
    jdash = _import_dashboard()
    p = str(tmp_path / "metrics.jsonl")
    _write_run(p)
    s = summarize(MetricsLogger.read_records(p))
    js = jax_summarize(MetricsLogger.read_records(p))
    assert _dump(s) == _dump(js)
    assert pdash.render_terminal(s, "src") == jdash.render_terminal(js, "src")
    assert pdash.render_html(s, "src") == jdash.render_html(js, "src")
    got = _scenario(pagg, MemorySink(), "two_streams")
    want = _scenario(jagg, JaxMemorySink(), "two_streams")
    ages = {"run-a/0": 1.5, "run-b/0": 40.0}
    assert pdash.render_fleet_terminal(got.rollup(), ages, "src") \
        == jdash.render_fleet_terminal(want.rollup(), ages, "src")
    assert pdash.render_fleet_html(got.rollup(), got.streams(), "src") \
        == jdash.render_fleet_html(want.rollup(), want.streams(), "src")


def test_record_buffer_equals_the_script():
    jdash = _import_dashboard()
    bufs = [pdash.RecordBuffer(max_steps=100), jdash.RecordBuffer(
        max_steps=100)]
    for buf in bufs:
        buf.feed([{"kind": "obs_epoch", "epoch": 1}])
        buf.feed([{"kind": "obs_step", "step": s, "step_time_s": 0.01}
                  for s in range(500)])
        buf.feed([{"kind": "obs_alert", "reason": "nan_loss", "step": 9}])
    assert bufs[0].snapshot() == bufs[1].snapshot()


def _no_clock(text):
    """The frame's and the report's headers carry the wall clock."""
    return re.sub(r"(\d{4}-\d\d-\d\d )?\b\d\d:\d\d:\d\d\b", "T", text)


@pytest.mark.parametrize("case", ["single", "single_html", "fleet_html",
                                  "fleet_rule", "fleet", "missing"])
def test_dashboard_cli_equals_the_script(tmp_path, case):
    """``python -m tpunet_torch.obs.cli.dashboard --once`` with no JAX:
    the exit code, the frame it prints and the HTML it writes equal the
    script's."""
    single = str(tmp_path / "run")
    os.makedirs(single)
    _write_run(os.path.join(single, "metrics.jsonl"))
    fleet = _write_stream_files(tmp_path)
    argv = {"single": [single, "--once"],
            "single_html": [single, "--once", "--html", "OUT"],
            "fleet_html": fleet + ["--once", "--html", "OUT"],
            "fleet_rule": fleet + ["--once", "--rule",
                                   "serve_queue_depth > 3",
                                   "--straggler-factor", "1.5"],
            "fleet": fleet + ["--once"],
            "missing": [str(tmp_path / "nothing"), "--once"]}[case]
    outs = {}
    for tag in ("port", "ref"):
        out = str(tmp_path / f"{tag}.html")
        args = [out if a == "OUT" else a for a in argv]
        p = (run_without_jax("tpunet_torch.obs.cli.dashboard", args)
             if tag == "port" else run_script("obs_dashboard.py", args))
        text = _no_clock((p.stdout + p.stderr).replace(out, "OUT").replace(
            "obs_dashboard.py", "PROG").replace("dashboard.py", "PROG"))
        outs[tag] = (p.returncode, text, _no_clock(
            open(out).read()) if os.path.exists(out) else None)
    assert outs["port"] == outs["ref"], outs["port"][1][-2000:]
    if case in ("single", "single_html", "fleet_html", "fleet_rule", "fleet"):
        assert outs["port"][0] == 0
    if case == "fleet_html":
        assert "Serve SLO (fleet)" in outs["port"][2]
