"""What the per-layer metric readers share.

A per-layer metric is the file ``portbench/metrics/<name>.py``, found by
the metric's name in ``BENCHMARK.json``. It defines ``read(ctx)``, which
returns the number or None when the run holds nothing for it to read
(the harness then leaves the metric out of the line), and may define
``COUNTERS``, {label: "module:attribute.path"} of program counters the
harness snapshots around the traced steps (``ctx.counters`` holds their
change).

``ctx`` (built by ``portbench.cell``) carries: ``config``, ``traffic``,
``chips``, ``peaks`` (the card's, or None), ``op_calls`` (a rank-step's
hand-kernel ops by family, at the layers' shapes), ``flops_per_sample``;
``window``, the traced run's window, before any profile, on rank 0
(``steps``, ``seconds``, ``samples_per_sec_per_chip``, ``data_wait_s``
and ``dispatch_s`` a step, ``collectives`` {name: (calls, host s)});
``traced``: ``steps`` and ``seconds`` of the device-traced steps, rank
0's ``summary`` of them and ``host_summary`` of the host-traced steps
(``portbench.trace.summary``), and ``ranks``, every rank's
``busy_us``/``seconds`` of the device-traced steps.
"""

from __future__ import annotations

import importlib
import importlib.util
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

from portbench import roofline

ROOT = Path(__file__).resolve().parent / "metrics"


def load(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``."""
    path = ROOT / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_counter(path: str) -> float:
    """The value of ``module:attribute.path``."""
    mod_name, attrs = path.split(":")
    obj = importlib.import_module(mod_name)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return float(obj)


def kernel_us(ctx, patterns) -> float:
    """Device us of the traced steps in kernels whose names match."""
    regs = [re.compile(p) for p in patterns]
    return sum(us for name, us in ctx.traced["summary"]["kernel_us"].items()
               if any(r.search(name) for r in regs))


def roofline_share(ctx, family: str, patterns,
                   counters: Dict[str, str]) -> Optional[float]:
    """Percent: the least time of the family's ops in the traced steps
    over its kernels' device time there. None when the card has no
    peaks, the family has no ops in this configuration, its kernels ran
    no time, or its launch counters show another number of calls than
    the layers' ops (the path did not go through the kernels as
    counted)."""
    calls = ctx.op_calls.get(family)
    if ctx.peaks is None or not calls:
        return None
    steps = ctx.traced["steps"]
    if any(ctx.counters.get(label) != steps * len(calls)
           for label in counters):
        return None
    spent = kernel_us(ctx, patterns) * 1e-6
    if spent <= 0:
        return None
    least = steps * roofline.least_seconds(family, calls, ctx.peaks)
    return 100.0 * least / spent
