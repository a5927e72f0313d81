"""tpucheck for the port — static analysis of ``tpunet_torch/``.

The port's copy of ``tpunet/analysis/`` (stdlib ``ast`` only, imports
nothing of tpunet): the rules that encode the reference's failure
history and carry over to PyTorch, checked on the port's own code
(``tpunet_torch/``, ``chip_smoke.py``, ``scripts/torch_*.py``):

- **R2 kernel-launch coverage** (``rules/launches.py``) — the
  counterpart of tpunet's named-scope coverage: every call of a kernel
  loaded through ``ops/_build.py`` inside ``tpunet_torch/ops/`` checks
  and raises on its return code and bumps its wrapper's ``.launches``
  counter in the same function, sits in no ``try`` that carries on and
  in no function that reads ``os.environ`` (ROADMAP port rule 3; the
  counters are what ``chip_smoke.py`` reads);
- **R4 thread-registry enforcement** — every ``threading.Thread`` /
  ``subprocess.Popen`` spawn in ``tpunet_torch/`` registers with the
  flightrec ``THREADS`` registry or is allowlisted (the flight
  recorder's own plumbing, the torch-free elastic agent);
- **R5 config/CLI/docs drift** — every ``ObsConfig`` / ``ModelConfig``
  / ``ServeConfig`` / ``RouterConfig`` field of ``tpunet_torch/
  config.py`` has a wired CLI flag in the port and a mention in
  README.md or ``docs/*.md``;
- **R6 metrics-schema instruments** — every literal instrument name in
  ``tpunet_torch/`` appears in the unedited ``docs/metrics_schema.md``.

Scoped out, with the reason:

- **R3 (host side effects inside jit)**: the port has no traced body.
  There is no ``torch.compile``, no ``torch.jit`` and no CUDA-graph
  capture anywhere in ``tpunet_torch/``; every ``print`` or
  ``time.*`` runs each time its line runs. The rule comes back over
  capture bodies if a CUDA graph of a step lands (ROADMAP H1).
- **R1 and R7 (donation aliasing, in a module and across modules)**:
  eager PyTorch donates no buffer. No call frees or reuses the memory
  of a tensor it is given, so the use-after-donate class (an IO view
  whose buffer a donated argument freed) cannot occur. Its nearest
  counterpart, a tensor aliasing host memory that something else owns
  and written in place or kept as state, has no instance: the mapped
  checkpoint of ``infer/generate.py`` is copied into the model's own
  parameters, and ``train/loop.py``'s and ``serve/engine.py``'s
  ``from_numpy`` tensors are only read.

Run ``python -m tpunet_torch.analysis``. Accepted findings live in
``tpunet_torch/analysis/baseline.json`` with a one-line justification
each; line-level escapes use ``# tpucheck: disable=R4`` comments.
"""

from __future__ import annotations

from tpunet_torch.analysis.baseline import Baseline
from tpunet_torch.analysis.core import Finding, Project, Rule, run_rules
from tpunet_torch.analysis.rules import ALL_RULES, rules_by_id

__all__ = [
    "ALL_RULES", "Baseline", "Finding", "Project", "Rule",
    "run_rules", "rules_by_id",
]
