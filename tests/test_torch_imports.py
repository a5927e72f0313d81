"""The port stands alone: no module of tpunet_torch, and not chip_smoke.py,
imports JAX (or flax/optax/orbax) or anything of the tpunet package, so a
machine with PyTorch and no JAX runs it."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

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
                         capture_output=True, text=True, timeout=300)
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
                "tpunet_torch.obs.flightrec.watch"):
        assert mod in res["mods"]
    assert res["bad"] == []


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py",
                                                "tests/_torch_dp_worker.py"])
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
