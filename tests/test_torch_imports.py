"""The port stands alone: no module of tpunet_torch, and not chip_smoke.py,
imports JAX (or flax/optax/orbax) or anything of the tpunet package, so a
machine with PyTorch and no JAX runs it."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import _torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpunet")
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "tpunet_torch").rglob("*.py"))


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax_or_tpunet():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tpunet_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "tpunet_torch.__path__, 'tpunet_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=_torch_threads.child_env())
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("tpunet_torch.serve.classify", "tpunet_torch.ops.fused_ir",
                "tpunet_torch.train.loop", "tpunet_torch.train.__main__",
                "tpunet_torch.data.augment", "tpunet_torch.ckpt",
                "tpunet_torch.parallel", "tpunet_torch.parallel.dist",
                "tpunet_torch.models.lm", "tpunet_torch.data.lm",
                "tpunet_torch.infer.generate", "tpunet_torch.serve.engine",
                "tpunet_torch.serve.frontend", "tpunet_torch.serve.__main__",
                "tpunet_torch.serve.sampling", "tpunet_torch.serve.scheduler",
                "tpunet_torch.serve.httpjson",
                "tpunet_torch.serve.prefixcache.cache",
                "tpunet_torch.serve.prefixcache.keys",
                "tpunet_torch.obs.registry", "tpunet_torch.obs.tracing",
                "tpunet_torch.obs.spans", "tpunet_torch.obs.flightrec.ring",
                "tpunet_torch.obs.flightrec.threads",
                "tpunet_torch.obs.flightrec.report",
                "tpunet_torch.obs.flightrec.crash",
                "tpunet_torch.obs.flightrec.watch",
                "tpunet_torch.obs.slo", "tpunet_torch.router",
                "tpunet_torch.router.__main__",
                "tpunet_torch.router.balance", "tpunet_torch.router.core",
                "tpunet_torch.router.frontend",
                "tpunet_torch.router.journal",
                "tpunet_torch.router.policy", "tpunet_torch.router.prober",
                "tpunet_torch.router.records",
                "tpunet_torch.router.replica",
                "tpunet_torch.router.supervisor",
                "tpunet_torch.utils.preemption", "tpunet_torch.data.native",
                "tpunet_torch.models.mobilenetv2", "tpunet_torch.models.vit",
                "tpunet_torch.train.state", "tpunet_torch.train.steps",
                "tpunet_torch.parallel.mesh", "tpunet_torch.parallel.tp",
                "tpunet_torch.ops.vocab_ce", "tpunet_torch.models.moe",
                "tpunet_torch.obs.agg", "tpunet_torch.obs.agg.alerts",
                "tpunet_torch.obs.agg.merge", "tpunet_torch.obs.agg.receiver",
                "tpunet_torch.obs.agg.rollup", "tpunet_torch.obs.history",
                "tpunet_torch.obs.history.compare",
                "tpunet_torch.obs.history.store",
                "tpunet_torch.obs.history.timeline",
                "tpunet_torch.obs.cli", "tpunet_torch.obs.cli.compare",
                "tpunet_torch.obs.cli.timeline",
                "tpunet_torch.obs.cli.dashboard",
                "tpunet_torch.obs.cli.report",
                "tpunet_torch.obs.trace_phase", "tpunet_torch.elastic",
                "tpunet_torch.elastic.__main__", "tpunet_torch.elastic.agent",
                "tpunet_torch.elastic.chaos", "tpunet_torch.elastic.events",
                "tpunet_torch.elastic.rendezvous"):
        assert mod in res["mods"]
    assert res["bad"] == []


def test_router_cli_runs_on_a_host_without_jax():
    """With JAX and tpunet unimportable, the router package imports and
    its CLI parses and prints its usage."""
    code = (
        "import runpy, sys\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        "import tpunet_torch.router.__main__ as cli\n"
        "import tpunet_torch.obs.slo\n"
        "from tpunet_torch.router import Router, RouterServer, Supervisor\n"
        "args = cli.build_argparser().parse_args(\n"
        "    ['--spawn', '2', '--', '--device', 'cpu'])\n"
        "assert args.spawn == 2 and args.serve_args[-2:] == "
        "['--device', 'cpu']\n"
        "sys.argv = ['tpunet_torch.router', '--help']\n"
        "runpy.run_module('tpunet_torch.router', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=_torch_threads.child_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: python -m tpunet_torch.router")


def test_obs_clis_and_moe_run_on_a_host_without_jax():
    """With JAX and tpunet unimportable, the MoE module imports, and the
    fleet history and aggregation CLIs print their usage."""
    code = (
        "import runpy, sys\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        "import tpunet_torch.models.moe, tpunet_torch.obs.agg\n"
        "import tpunet_torch.obs.history\n"
        "sys.argv = ['dashboard', '--help']\n"
        "try:\n"
        "    runpy.run_module('tpunet_torch.obs.cli.dashboard',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=_torch_threads.child_env())
    assert out.returncode == 0, out.stderr
    for flag in ("--fleet", "--straggler-factor", "--html", "--listen"):
        assert flag in out.stdout, flag


def test_sharded_modules_and_train_help_without_jax():
    """With JAX and tpunet unimportable, the mesh, the rule table and the
    vocab-parallel CE import, and the training CLI's usage lists
    tpunet's mesh flags."""
    code = (
        "import runpy, sys\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        "import tpunet_torch.parallel.mesh, tpunet_torch.parallel.tp\n"
        "import tpunet_torch.ops.vocab_ce\n"
        "sys.argv = ['tpunet_torch.train', '--help']\n"
        "runpy.run_module('tpunet_torch.train', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=_torch_threads.child_env())
    assert out.returncode == 0, out.stderr
    for flag in ("--mesh-data", "--mesh-seq", "--mesh-pipe", "--mesh-model",
                 "--zero1", "--fsdp", "--vocab-ce", "--moe-experts",
                 "--moe-dispatch"):
        assert flag in out.stdout, flag


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py",
                                                "tests/_torch_dp_worker.py",
                                                "tests/_torch_shard_worker.py"])
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == [], f"{path} imports {bad}"


@pytest.mark.parametrize("path", ["tpunet_torch/elastic/__init__.py",
                                  "tpunet_torch/elastic/__main__.py",
                                  "tpunet_torch/elastic/agent.py",
                                  "tpunet_torch/elastic/events.py",
                                  "tpunet_torch/elastic/rendezvous.py"])
def test_elastic_agent_imports_no_torch(path):
    """The agent is a stdlib supervisor: it imports no torch, and nothing
    of the port outside tpunet_torch/elastic/ (the package reaches chaos,
    which records into the flight recorder, only on first use)."""
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 and node.module else [])
        for name in names:
            if name.split(".")[0] in ("torch", "numpy") or (
                    name.startswith("tpunet_torch")
                    and not name.startswith("tpunet_torch.elastic")):
                bad.append(name)
    assert bad == [], f"{path} imports {bad}"
