"""Tests of the benchmark harness, on the CPU (``python -m pytest
portbench``); the ``cuda`` cases run the control at a cell's own size on
a card and skip without one.

The CPU runs use a temporary copy of ``portbench/`` and
``BENCHMARK.json`` with tiny cells added as files of their own, in
float32, where the port and the reference agree to rounding: a sound run
is ``correct`` under the real configurations' limits, and each fault
planted under the timed path makes it false.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path[:] = [str(REPO)] + [p for p in sys.path
                             if Path(p or ".").resolve() != HERE]

from portbench import readers, roofline  # noqa: E402
from portbench.reference import mobilenet_v2, vit  # noqa: E402
from portbench.reference import train as reference  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "tpunet"}
PEAKS = roofline.peaks("NVIDIA H100 80GB HBM3")


def _load(rel: str) -> dict:
    return json.loads((REPO / rel).read_text())


# -- the arithmetic of the yardstick -----------------------------------


def test_peaks_are_the_h100_sxm_data_sheet():
    assert PEAKS == {"bf16": 989e12, "f32": 67e12, "hbm": 3.35e12}
    assert roofline.peaks("cpu") is None


@pytest.mark.parametrize("family,call,want", [
    # 112 x 112 x 32 at batch 128, stride 1: forward reads x, w and writes
    # y (bf16), 205,521,472 bytes; backward reads x, dy, w, writes dx, dw,
    # 308,282,496 bytes; both over HBM, the 9-tap FMAs are below them.
    ("depthwise", (128, 112, 112, 32, 1),
     205_521_472 / 3.35e12 + 308_282_496 / 3.35e12),
    # m = 128 * 56 * 56, 24 -> 144: forward 2 * m * 24 * 144 = 2.7746e9
    # FLOPs (2.81e-6 s at 989e12) against 136,286,880 bytes (4.07e-5 s);
    # backward 2 * (m*24 + m*144) + 3456 bf16 words + 6*144 + 3456 f32.
    ("fused_ir", (401_408, 24, 144),
     (2 * (401_408 * 24 + 3_456 + 401_408 * 144) + 2 * 144 * 4) / 3.35e12
     + (2 * (2 * 401_408 * 24 + 2 * 401_408 * 144 + 3_456)
        + 6 * 144 * 4 + 3_456 * 4) / 3.35e12),
    # ViT-B/16 at batch 128: x = 128*196*12*64*2 = 38,535,168 bytes, lse
    # 128*12*196*4 = 1,204,224; forward 4x + lse (bytes bound), backward
    # 8x + lse against 5 products of 2*128*12*196^2*64 = 7.5531e9 FLOPs
    # (3.82e-5 s) - bytes bound too (9.24e-5 s).
    ("flash", (128, 196, 12, 64),
     (4 * 38_535_168 + 1_204_224) / 3.35e12
     + (8 * 38_535_168 + 1_204_224) / 3.35e12),
])
def test_least_time_by_hand(family, call, want):
    assert roofline.least_seconds(family, [call], PEAKS) == \
        pytest.approx(want, rel=1e-12)


def test_flash_least_time_turns_to_operations_at_long_sequences():
    b, t, h, d = 1, 8192, 1, 128
    product = 2 * b * h * t * t * d
    assert roofline.flash((b, t, h, d), PEAKS) == pytest.approx(
        2 * product / 989e12 + 5 * product / 989e12, rel=1e-12)


def test_parameter_counts_and_flops_a_sample():
    mnv2 = _load("portbench/configs/mnv2_1.0_224.json")
    vitb = _load("portbench/configs/vit_b16_224.json")
    count = lambda spec: sum(  # noqa: E731
        __import__("math").prod(s) for _, s, _ in spec)
    assert count(reference.param_spec(mnv2)) == mnv2["parameters"] \
        == 2_236_682
    # 768*3*16*16 + 768 + 196*768 + 12 * 7,087,872 + 2*768 + 768*10 + 10
    assert count(reference.param_spec(vitb)) == 85_804_810
    assert mobilenet_v2.train_flops_per_sample(mnv2, 224) == 1.8e9
    # 196 tokens * (6 * 85,804,810 + 12 * 12 * 196 * 768)
    assert vit.train_flops_per_sample(vitb, 224) == \
        196 * (6 * 85_804_810 + 12 * 12 * 196 * 768)


def test_mfu_by_hand():
    mod = readers.load("mfu_pct")
    ctx = type("Ctx", (), {})()
    ctx.peaks, ctx.flops_per_sample = PEAKS, 1.8e9
    ctx.window = {"samples_per_sec_per_chip": 1250.0}
    # 1250 images/s * 1.8 GFLOP / 989 TFLOP/s = 0.2275 %
    assert mod.read(ctx) == pytest.approx(100 * 1250 * 1.8e9 / 989e12)


def test_op_calls_at_the_layers_shapes():
    mnv2 = _load("portbench/configs/mnv2_1.0_224.json")
    calls = mobilenet_v2.op_calls(mnv2, 128, 224)
    assert len(calls["depthwise"]) == 17 and len(calls["fused_ir"]) == 33
    shapes = {}
    for n, h, w, c, s in calls["depthwise"]:
        shapes[(h, c, s)] = shapes.get((h, c, s), 0) + 1
    assert shapes == {(112, 32, 1): 1, (112, 96, 2): 1, (56, 144, 1): 1,
                      (56, 144, 2): 1, (28, 192, 1): 2, (28, 192, 2): 1,
                      (14, 384, 1): 4, (14, 576, 1): 2, (14, 576, 2): 1,
                      (7, 960, 1): 3}
    vitb = _load("portbench/configs/vit_b16_224.json")
    assert vit.op_calls(vitb, 128, 224) == {"flash": [(128, 196, 12, 64)]
                                            * 12}


# -- imports -------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = set(_imports(path))
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.parts:
        assert "tpunet_torch" not in tops


# -- whole runs on the CPU, in a copy -----------------------------------

TINY_MNV2 = {"width_mult": 0.25, "image_size": 32, "dtype": "float32"}
TINY_VIT = {"hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 128,
            "patch_size": 4, "image_size": 32, "dtype": "float32"}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A checkout of the benchmark with tiny cells added as new files:
    two configurations, two traffic mixes and a per-layer metric, and
    their cells appended to BENCHMARK.json; no file of ``portbench/``
    is edited."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pb = root / "portbench"
    m = _load("portbench/configs/mnv2_1.0_224.json")
    m.update(TINY_MNV2, name="mnv2_tiny")
    m["port"].update(width_mult=0.25, dtype="float32")
    v = _load("portbench/configs/vit_b16_224.json")
    v.update(TINY_VIT, name="vit_tiny")
    v["port"] = {"name": "vit", "num_classes": 10, "dropout_rate": 0.2,
                 "attention": "flash", "dtype": "float32",
                 "param_dtype": "float32", "vit_patch": 4, "vit_hidden": 32,
                 "vit_depth": 2, "vit_heads": 2}
    for c in (m, v):
        (pb / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    t = _load("portbench/traffic/cifar10_224_aug.b128.json")
    t.update(name="tiny.b8", batch_per_rank=8, setup_steps=4,
             trace_steps=2)
    t["dataset"].update(train_rows=256, test_rows=8)
    (pb / "traffic" / "tiny.b8.json").write_text(json.dumps(t))
    t.update(name="tiny.dp2_b8", ranks=2, setup_steps=16, trace_steps=16)
    (pb / "traffic" / "tiny.dp2_b8.json").write_text(json.dumps(t))
    (pb / "metrics" / "traced_steps.py").write_text(
        "def read(ctx):\n    return float(ctx.traced['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in (m, v):
        bench["configs"].append({"name": c["name"], "source": "test",
                                 "file": f"portbench/configs/{c['name']}"
                                         ".json", "reduced": [],
                                 "why": "test"})
    bench["workloads"] += [
        {"name": "mnv2_tiny.t", "config": "mnv2_tiny", "traffic": "tiny.b8",
         "chips": 1, "why": "test"},
        {"name": "vit_tiny.t", "config": "vit_tiny", "traffic": "tiny.b8",
         "chips": 1, "why": "test"},
        {"name": "mnv2_tiny.dp2", "config": "mnv2_tiny",
         "traffic": "tiny.dp2_b8", "chips": 2, "why": "test"}]
    bench["per_layer"].append({"name": "traced_steps", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "Device", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    return root


WORKER = """
import sys
fault = sys.argv[1]
sys.path.insert(0, sys.argv[2])
import torch
if fault == "unchanged":
    torch.optim.Adam.step = lambda self, closure=None: None
elif fault == "half":
    from tpunet_torch.train import steps
    fit = steps.fit_batch
    steps.fit_batch = lambda state, x, y, *a, **k: fit(
        state, x[: len(x) // 2], y[: len(y) // 2], *a, **k)
elif fault == "exchange":
    import torch.distributed as d
    d.all_reduce = lambda *a, **k: None
from portbench import run
sys.exit(run.main(sys.argv[3:]))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("BENCH_RUN", None)
    return env


def _run(copy, workload, trace=0, fault="none", seed=3_000_000_019):
    worker = copy / "worker.py"
    worker.write_text(WORKER)
    args = ["--workload", workload, "--seed", str(seed), "--seconds", "1",
            "--trace", str(trace), "--device", "cpu"]
    mix = json.loads((copy / "BENCHMARK.json").read_text())
    cell = next(w for w in mix["workloads"] if w["name"] == workload)
    ranks = 2 if cell["chips"] == 2 else 1
    if ranks == 1:
        out = subprocess.run([sys.executable, str(worker), fault, str(copy),
                              *args], cwd=copy, env=_env(),
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        init = f"tcp://localhost:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, str(worker), fault,
                               str(copy), *args, "--init", init, "--rank",
                               str(r)], cwd=copy, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(ranks)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["mnv2_tiny.t", "vit_tiny.t"])
def test_sound_run_is_correct_and_reports_its_metrics(copy, workload):
    res = _run(copy, workload)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_samples_per_sec_per_chip",
                                   "step_ms_p95", "setup_s"}
    assert list(res)[-1] == "checks"
    traced = _run(copy, workload, trace=1)
    assert traced["correct"]
    # The metric added as a file of its own is read by name.
    assert traced["metrics"]["traced_steps"]["value"] == 2.0
    assert "host_dispatch_ms" in traced["metrics"]
    assert "busy_s" in traced["device"] and "window_s" in traced["device"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_fault_under_the_timed_path_is_not_correct(copy, fault):
    res = _run(copy, "mnv2_tiny.t", fault=fault)
    assert not res["correct"], res["checks"]


def test_two_ranks_are_correct_and_the_exchange_left_out_is_not(copy):
    assert _run(copy, "mnv2_tiny.dp2")["correct"]
    res = _run(copy, "mnv2_tiny.dp2", fault="exchange")
    assert not res["correct"], res["checks"]


def test_a_directory_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "mnv2_224.train.b128", "--seed", "1", "--seconds",
                          "1", "--trace", "0", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


# -- the control at a cell's own size, on a card --------------------------


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mnv2_224.train.b128",
                                      "vit_b16_224.train.b128"])
def test_control_fails_a_limit_at_the_cells_size(card, workload):
    from portbench import control
    from portbench.run import load_cell
    _, _, cfg, mix = load_cell(workload)
    got = control.readings(cfg, mix, 424_242, ["fp8"], card)["fp8"]
    assert any(got[k] > cfg["limits"][k] for k in cfg["limits"]), got


def test_control_fails_a_limit_at_a_tiny_size():
    """The same control at a size a CPU holds, against the real limits of
    the configuration it shrinks."""
    import torch

    from portbench import control
    cfg = _load("portbench/configs/mnv2_1.0_224.json")
    cfg.update(TINY_MNV2)
    mix = _load("portbench/traffic/cifar10_224_aug.b128.json")
    mix.update(batch_per_rank=8)
    mix["dataset"].update(train_rows=64)
    got = control.readings(cfg, mix, 7, ["fp8"], torch.device("cpu"))["fp8"]
    assert any(got[k] > cfg["limits"][k] for k in cfg["limits"]), got
