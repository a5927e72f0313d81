"""Device time by training phase (``tpunet_torch.obs.trace_phase``) and
the port's ``obs_report`` (``python -m tpunet_torch.obs.cli.report``),
on the CPU.

- A trainer epoch through the CLI (MobileNetV2 at width 0.5, mixup and
  EMA on) with a profile window of 2 steps: the phases of its
  ``torch.profiler`` trace (a CPU trace: the work is the leaf CPU ops)
  hold ``augment``, ``fwd``, ``bwd``, ``optimizer`` and ``ema`` time and
  sum to the trace's total; ``--trace`` prints the table.
- A hand-made trace of the card's shape: kernels attributed through
  their launch's correlation id to the innermost phase range on the
  launching thread, backward launches (under
  ``autograd::engine::evaluate_function``, on the autograd engine's
  thread) to ``bwd``, memcpy and memset counted, a launch outside the
  trace to ``other``.
- ``phase_times`` has tpunet's output (``tpunet.obs.trace_phase``) for
  the same time by phase.
- The report CLI prints what ``scripts/obs_report.py`` prints on the
  same ``metrics.jsonl``, as text and as ``--json``.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import _torch_threads
from tpunet_torch.obs import trace_phase as tp

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("phase_run")
    out = subprocess.run(
        [sys.executable, "-m", "tpunet_torch.train", "--preset", "serial",
         "--dataset", "synthetic", "--synthetic-size", "64",
         "--image-size", "32", "--width-mult", "0.5", "--dtype", "float32",
         "--batch-size", "16", "--epochs", "1", "--device", "cpu",
         "--mixup", "0.2", "--ema-decay", "0.99", "--no-native-loader",
         "--profile-start-step", "1", "--profile-num-steps", "2",
         "--checkpoint-dir", str(d)], cwd=ROOT,
        env=_torch_threads.child_env(), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return d


def test_phase_times_of_a_profiled_cpu_step(run):
    rows = tp.trace_rows(str(run / "profile"))
    phases = tp.phase_times(rows)
    for ph in ("augment", "fwd", "bwd", "optimizer", "ema"):
        assert phases.get(ph, {}).get("us", 0) > 0, phases
    assert set(phases) <= set(tp.PHASES)
    total = tp.device_total_us(rows)
    assert sum(r["us"] for r in phases.values()) == pytest.approx(
        total, abs=0.05 * len(phases) + 1e-6)
    assert sum(r["pct"] for r in phases.values()) == pytest.approx(
        100.0, abs=0.01 * len(phases))
    # ordered by time
    times = [r["us"] for r in phases.values()]
    assert times == sorted(times, reverse=True)


def _x(name, ts, dur, tid, cat="cpu_op", pid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "cat": cat, "args": args}


def test_device_work_goes_to_its_launch_phase():
    main, bwd_thread, gpu = 10, 11, 0
    events = [
        _x("tpunet_augment", 0, 10, main, "user_annotation"),
        _x("cudaLaunchKernel", 2, 1, main, "cuda_runtime", correlation=1),
        _x("tpunet_fwd_bwd", 20, 50, main, "user_annotation"),
        _x("cudaLaunchKernel", 22, 1, main, "cuda_runtime", correlation=2),
        _x("cudaMemcpyAsync", 24, 1, main, "cuda_runtime", correlation=3),
        # the backward, on the autograd engine's thread
        _x("autograd::engine::evaluate_function: MmBackward0", 30, 10,
           bwd_thread),
        _x("cudaLaunchKernel", 31, 1, bwd_thread, "cuda_runtime",
           correlation=4),
        _x("cudaMemsetAsync", 33, 1, bwd_thread, "cuda_runtime",
           correlation=5),
        _x("tpunet_optimizer", 80, 10, main, "user_annotation"),
        _x("cudaLaunchKernel", 81, 1, main, "cuda_runtime", correlation=6),
        _x("tpunet_ema", 90, 5, main, "user_annotation"),
        _x("cudaLaunchKernel", 91, 1, main, "cuda_runtime", correlation=7),
        # a launch outside every range, and a kernel whose launch the
        # trace does not hold
        _x("cudaLaunchKernel", 100, 1, main, "cuda_runtime", correlation=8),
        # the device's side of the ranges is not a launch
        _x("tpunet_fwd_bwd", 20, 60, 7, "gpu_user_annotation", pid=gpu),
    ]
    work = [("kernel", 1, 3.0), ("kernel", 2, 5.0), ("gpu_memcpy", 3, 2.0),
            ("kernel", 4, 7.0), ("gpu_memset", 5, 1.0), ("kernel", 6, 4.0),
            ("kernel", 7, 0.5), ("kernel", 8, 1.5), ("kernel", 99, 2.5)]
    for i, (cat, corr, dur) in enumerate(work):
        events.append(_x(f"k{i}", 200 + 10 * i, dur, 7, cat, pid=gpu,
                         correlation=corr))
    rows = tp.kernel_rows(events)
    assert [r["phase"] for r in rows] == [
        "augment", "fwd", "fwd", "bwd", "bwd", "optimizer", "ema", "other",
        "other"]
    phases = tp.phase_times(rows)
    assert phases == {
        "bwd": {"us": 8.0, "pct": 30.19}, "fwd": {"us": 7.0, "pct": 26.42},
        "optimizer": {"us": 4.0, "pct": 15.09},
        "other": {"us": 4.0, "pct": 15.09},
        "augment": {"us": 3.0, "pct": 11.32},
        "ema": {"us": 0.5, "pct": 1.89}}
    assert tp.device_total_us(rows) == 26.5


def test_cpu_trace_counts_leaf_ops_at_their_place():
    t = 5
    events = [
        _x("tpunet_fwd_bwd", 0, 100, t, "user_annotation"),
        _x("aten::linear", 1, 20, t),
        _x("aten::addmm", 2, 15, t),          # leaf inside linear
        _x("autograd::engine::evaluate_function: AddmmBackward0", 30, 20,
           t),
        _x("aten::mm", 31, 8, t),             # leaf: backward
        _x("aten::add_", 60, 2, t),           # leaf: fwd
        _x("aten::zero_", 120, 3, t),         # leaf: other
    ]
    rows = tp.kernel_rows(events)
    assert sorted((r["name"], r["phase"], r["us"]) for r in rows) == [
        ("aten::add_", "fwd", 2.0), ("aten::addmm", "fwd", 15.0),
        ("aten::mm", "bwd", 8.0), ("aten::zero_", "other", 3.0)]


def test_phase_times_shape_equals_tpunets():
    from tpunet.obs.trace_phase import phase_times as jax_phase_times
    by_phase = {"fwd": 40.0, "bwd": 75.5, "optimizer": 12.25, "ema": 3.0,
                "augment": 9.0, "eval": 6.5, "other": 1.0}
    names = {"fwd": "jit(step)/tpunet_fwd_bwd/jvp(dense)/dot_general",
             "bwd": "jit(step)/tpunet_fwd_bwd/transpose(jvp(dense))/dot",
             "optimizer": "jit(step)/tpunet_optimizer/add",
             "ema": "jit(step)/tpunet_ema/mul",
             "augment": "jit(step)/tpunet_augment/gather",
             "eval": "jit(eval)/tpunet_eval_forward/dot", "other": "copy"}
    jax_rows = [{"Framework op name": names[ph], "Total self time (us)": us}
                for ph, us in by_phase.items()]
    rows = [{"name": ph, "phase": ph, "us": us} for ph, us in
            by_phase.items()]
    assert tp.phase_times(rows) == jax_phase_times(jax_rows)


def _cli(args):
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         env=_torch_threads.child_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("extra", [[], ["--json"]], ids=["text", "json"])
def test_report_cli_prints_what_obs_report_prints(run, extra):
    metrics = str(run / "metrics.jsonl")
    got = _cli(["-m", "tpunet_torch.obs.cli.report", metrics, *extra])
    want = _cli(["scripts/obs_report.py", metrics, *extra])
    assert got == want
    if extra:
        assert json.loads(got)["totals"]["epochs"] == 1


def test_report_cli_trace_prints_the_phase_table(run):
    got = _cli(["-m", "tpunet_torch.obs.cli.report", str(run), "--trace",
                str(run / "profile")])
    table = got.split("== device time by phase (profiled window) ==")[1]
    lines = table.strip().splitlines()
    assert lines[0].split() == ["phase", "ms/window", "share"]
    phases = {ln.split()[0] for ln in lines[1:]}
    assert {"augment", "fwd", "bwd", "optimizer", "ema"} <= phases
    # the run directory finds its profile by itself
    assert _cli(["-m", "tpunet_torch.obs.cli.report", str(run)]) == got
    got = json.loads(_cli(["-m", "tpunet_torch.obs.cli.report", str(run),
                           "--json"]))
    assert got["device_phases"]["bwd"]["us"] > 0
