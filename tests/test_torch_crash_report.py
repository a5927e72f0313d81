"""``python -m tpunet_torch.obs.cli.crash_report`` against
``scripts/obs_crash_report.py``, on the CPU.

Two reports go through both: one that the port's flight recorder leaves
for a child process that is SIGKILLed (the watcher assembles it), and
the report dict of tests/test_flightrec.py's renderer test. The port's
CLI runs with JAX and tpunet unimportable, the script as it is, and
their text and ``--json`` outputs must be equal byte for byte; so must
their resolution of a run dir that holds only an archived report, and
their ``--assemble`` of the recorder's artifacts (apart from the
assembly time).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from tpunet.obs.flightrec import report as jax_report
from tpunet_torch.obs.cli import crash_report as pcr
from tpunet_torch.obs.flightrec import report as port_report

import _torch_threads
from test_torch_obs_history import run_script, run_without_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "tpunet_torch.obs.cli.crash_report"
SCRIPT = "obs_crash_report.py"

# The port's recorder in a child process: a registered thread, a few
# events, a device-memory sample, then SIGKILL (no handler runs; the
# watcher sees the pipe close without the clean marker).
_CHILD = r"""
import os, signal, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "tpunet"):
    sys.modules[name] = None
from tpunet_torch.obs import flightrec

rec = flightrec.install({workdir!r}, run_id="r-crash")
handle = flightrec.register_thread("child-worker", stall_after_s=60.0)
handle.beat("busy")
rec.refresh_threads()
rec.set_device_memory([{{"device": 0, "bytes_in_use": 3 * 2 ** 20,
                        "peak_bytes_in_use": 5 * 2 ** 20}}])
for i in range(5):
    flightrec.record("span", f"step {{i}}")
flightrec.record("chaos", "SIGKILL injected")
os.kill(os.getpid(), signal.SIGKILL)
"""

# tests/test_flightrec.py's renderer fixture, every section present.
REPORT = {"version": 1, "cause": "SIGABRT", "signal": 6,
          "assembled_t": 1e9,
          "meta": {"pid": 7, "argv": ["train.py"], "run_id": "r1",
                   "started_t": 1e9},
          "events": [{"seq": 1, "t": 1e9, "kind": "span",
                      "msg": "step 1"}],
          "threads": [{"name": "ckpt-writer", "state": "busy",
                       "age_s": 2.0, "beats": 3,
                       "stall_after_s": 600.0}],
          "stacks": {"fatal": "Aborted", "threads": [
              {"ident": "0x1", "current": True,
               "frames": ['File "x.py", line 1 in f']}]},
          "native_journal": {"signal": 6, "ops": [
              {"seq": 1, "op": "create", "tid": 1, "a": 8, "b": 4}]},
          "device_memory": {"sampled_t": 1e9, "devices": [
              {"device": 0, "bytes_in_use": 2 ** 20,
               "peak_bytes_in_use": 2 ** 21}]}}


@pytest.fixture(scope="module")
def killed_run(tmp_path_factory):
    """A run dir whose flightrec/ holds the report the port's watcher
    assembled after the child's SIGKILL."""
    run = str(tmp_path_factory.mktemp("killed") / "run")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(workdir=run)],
        capture_output=True, text=True, timeout=120,
        env=_torch_threads.child_env(PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    path = os.path.join(run, "flightrec", port_report.REPORT_NAME)
    deadline = time.monotonic() + 30.0
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert os.path.exists(path), f"no crash report: {proc.stderr}"
    return run


@pytest.fixture
def fixture_run(tmp_path):
    run = tmp_path / "run"
    (run / "flightrec").mkdir(parents=True)
    with open(run / "flightrec" / "crash_report.json", "w") as f:
        json.dump(REPORT, f)
    return str(run)


def _both(argv, cwd=REPO):
    port = run_without_jax(MODULE, argv, cwd=cwd)
    ref = run_script(SCRIPT, argv, cwd=cwd)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    return port.stdout, ref.stdout


def test_killed_childs_report_is_the_recorders(killed_run):
    with open(os.path.join(killed_run, "flightrec",
                           "crash_report.json")) as f:
        rep = json.load(f)
    assert rep["cause"] == "died-without-fatal-signal"
    assert rep["meta"]["run_id"] == "r-crash"
    assert [t["name"] for t in rep["threads"]] == ["child-worker"]
    assert [e["msg"] for e in rep["events"]][-1] == "SIGKILL injected"
    assert rep["device_memory"]["devices"][0]["bytes_in_use"] == 3 * 2 ** 20


@pytest.fixture(scope="module")
def occ():
    """The script as a module (for its resolution, in process)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return __import__("obs_crash_report")
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("which", ["killed", "fixture"])
@pytest.mark.parametrize("mode", ["text", "json"])
def test_output_equals_the_scripts(request, occ, which, mode):
    run = request.getfixturevalue(f"{which}_run")
    flags = ["--json"] if mode == "json" else []
    for target in (run, os.path.join(run, "flightrec"),
                   os.path.join(run, "flightrec", "crash_report.json")):
        assert pcr.find_report(target) == occ.find_report(target)
    port, ref = _both(flags + [os.path.join(run, "flightrec")
                               if which == "killed" else run])
    assert port == ref
    if mode == "text":
        for needle in ("tpunet crash report — ", "EVENT RING TAIL",
                       "DEVICE MEMORY", "HOST THREADS"):
            assert needle in port, needle
        if which == "killed":
            assert "cause: died-without-fatal-signal" in port
            assert "child-worker" in port and "3.0 MiB in use" in port
    else:
        with open(os.path.join(run, "flightrec",
                               "crash_report.json")) as f:
            assert json.loads(port) == json.load(f)


def test_events_flag_equals_the_scripts(killed_run):
    port, ref = _both(["--events", "2", killed_run])
    assert port == ref and "last 2 of" in port


def test_archive_only_resolution(tmp_path, killed_run):
    run = tmp_path / "archived"
    shutil.copytree(killed_run, run)
    flightdir = run / "flightrec"
    os.rename(flightdir / "crash_report.json",
              flightdir / "crash_report.123.json")
    os.utime(flightdir / "crash_report.123.json", (2e9, 2e9))
    shutil.copyfile(flightdir / "crash_report.123.json",
                    flightdir / "crash_report.45.json")
    os.utime(flightdir / "crash_report.45.json", (1e9, 1e9))
    assert pcr.find_report(str(run)).endswith("crash_report.123.json")
    port, ref = _both([str(run)])
    assert port == ref
    assert port.splitlines()[0].endswith("crash_report.123.json")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no crash_report"):
        pcr.find_report(str(empty))


def _without_assembly_time(text):
    return [line for line in text.splitlines()
            if not line.startswith("pid ")]


def test_assemble_equals_the_scripts(tmp_path, killed_run):
    """``--assemble`` of the run dir (port) and of its flightrec dir
    (script), each on its own copy: the same report apart from its
    assembly time, and tpunet's ``assemble`` agrees on the port's
    artifacts."""
    outs = {}
    for tool, target in (("port", "run"), ("ref", "flightrec")):
        run = tmp_path / tool
        shutil.copytree(killed_run, run)
        os.remove(run / "flightrec" / "crash_report.json")
        path = str(run if target == "run" else run / "flightrec")
        res = (run_without_jax(MODULE, ["--assemble", path]) if tool ==
               "port" else run_script(SCRIPT, ["--assemble", path]))
        assert res.returncode == 0, res.stderr
        outs[tool] = res.stdout.replace(str(run), "RUN")
        with open(run / "flightrec" / "crash_report.json") as f:
            outs[tool + "_json"] = json.load(f)
    assert _without_assembly_time(outs["port"]) == \
        _without_assembly_time(outs["ref"])
    port_rep, ref_rep = outs["port_json"], outs["ref_json"]
    port_rep.pop("assembled_t")
    ref_rep.pop("assembled_t")
    assert port_rep == ref_rep
    jax_rep = jax_report.assemble(os.path.join(killed_run, "flightrec"))
    jax_rep.pop("assembled_t")
    assert jax_rep == ref_rep


def test_render_equals_the_scripts_in_process(occ, fixture_run):
    path = pcr.find_report(fixture_run)
    assert path == occ.find_report(fixture_run)
    for tail in (1, 40):
        assert pcr.render(REPORT, path, tail) == \
            occ.render(REPORT, path, tail)
