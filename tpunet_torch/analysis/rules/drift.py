"""R5 — config/CLI/docs drift for the user-facing config surfaces.

A copy of tpunet's R5 over the port's ``tpunet_torch/config.py``: the
flags are searched in the port's ``add_argument`` calls (the analysed
roots hold no tpunet code), the docs corpus is README.md plus
``docs/*.md`` as tpunet's.

A dataclass field that no CLI flag reaches is a knob only code edits
can turn; a flag no doc mentions is a knob only archaeology finds.
Both happen one innocent field at a time. This rule closes the loop
for the three surfaces operators actually touch — ``ObsConfig``,
``ModelConfig``, ``ServeConfig``:

- **CLI**: every field must correspond to an ``add_argument`` flag
  somewhere in the tree — by name (``step_records_every`` ↔
  ``--step-records-every``), by the repo's historical renames
  (``_FLAG_ALIASES``), or by a ``--no-X`` boolean form;
- **docs**: the field name (or its flag) must appear in README.md or
  docs/*.md — with ``docs/static_analysis.md`` excluded from the
  corpus so the rule's own catalog can't satisfy the check it
  enforces.

``RouterConfig`` joined the target set with the routing front tier
(tpunet_torch/router/): its knobs are exactly the kind operators reach for
mid-incident (probe cadence, eviction budget, scale thresholds), so
an unwired field there is drift at its most expensive.

Fields that are deliberately not CLI-wired (derived values, research
knobs) belong in the baseline with the reason — that is a reviewed
decision, not drift.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from tpunet_torch.analysis.core import (Finding, Project, Rule,
                                        call_name, const_str)

TARGET_CLASSES: Tuple[str, ...] = ("ObsConfig", "ModelConfig",
                                   "ServeConfig", "RouterConfig")

#: Historical flag renames: "Class.field" -> the flag that wires it.
_FLAG_ALIASES: Dict[str, str] = {
    "ModelConfig.name": "--model",
    "ModelConfig.pretrained_path": "--pretrained",
    "ModelConfig.use_pallas_depthwise": "--pallas-depthwise",
    "ObsConfig.enabled": "--no-obs",
    "ObsConfig.step_records_every": "--obs-step-every",
    "ObsConfig.hbm_attrib": "--obs-hbm-attrib",
    "ObsConfig.heartbeat_timeout_s": "--heartbeat-timeout",
    "ObsConfig.gauge_rules": "--obs-rule",
    "ObsConfig.histogram_max_samples": "--obs-hist-samples",
    "ServeConfig.default_max_new_tokens": "--max-new-tokens",
    "ServeConfig.default_deadline_s": "--deadline-s",
}

#: Markdown files excluded from the docs corpus (self-reference guard).
_DOCS_EXCLUDE = ("docs/static_analysis.md",)


def _is_dataclass_class(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        name = (call_name(dec) if isinstance(dec, ast.Call)
                else (dec.id if isinstance(dec, ast.Name) else ""))
        if isinstance(dec, ast.Attribute):
            name = dec.attr
        if name.rsplit(".", 1)[-1] == "dataclass":
            return True
    return False


def _nested_config_default(node: ast.AnnAssign) -> bool:
    """True for ``field(default_factory=SomeConfig)`` fields — nested
    config objects are surfaces of their own, not scalar knobs."""
    if isinstance(node.value, ast.Call) \
            and call_name(node.value).rsplit(".", 1)[-1] == "field":
        for kw in node.value.keywords:
            if kw.arg == "default_factory" \
                    and isinstance(kw.value, ast.Name) \
                    and kw.value.id.endswith("Config"):
                return True
    return False


class DriftRule(Rule):
    id = "R5"
    name = "config-cli-docs-drift"
    doc = ("every ObsConfig/ModelConfig/ServeConfig/RouterConfig "
           "field has a wired CLI flag and a docs mention")

    def run(self, project: Project) -> List[Finding]:
        fields: List[Tuple[str, str, str, int]] = []  # cls, field, path, line
        flags: Set[str] = set()
        for src in project.files():
            if src.tree is None:
                continue
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef) \
                        and node.name in TARGET_CLASSES \
                        and _is_dataclass_class(node):
                    for stmt in node.body:
                        if not isinstance(stmt, ast.AnnAssign) \
                                or not isinstance(stmt.target, ast.Name):
                            continue
                        fname = stmt.target.id
                        if fname.startswith("_") \
                                or _nested_config_default(stmt):
                            continue
                        fields.append((node.name, fname, src.rel,
                                       stmt.lineno))
                if isinstance(node, ast.Call) \
                        and call_name(node).endswith("add_argument"):
                    for arg in node.args:
                        s = const_str(arg)
                        if s and s.startswith("--"):
                            flags.add(s)
        docs_text = "\n".join(
            text for rel, text in project.md_files()
            if rel not in _DOCS_EXCLUDE)

        findings: List[Finding] = []
        for cls, fname, path, line in fields:
            dashed = "--" + fname.replace("_", "-")
            candidates = {dashed, f"--no-{fname.replace('_', '-')}"}
            alias = _FLAG_ALIASES.get(f"{cls}.{fname}")
            if alias:
                candidates.add(alias)
            wired = sorted(candidates & flags)
            if not wired:
                findings.append(Finding(
                    rule="R5", path=path, line=line,
                    message=(f"{cls}.{fname} has no CLI flag (looked "
                             f"for {', '.join(sorted(candidates))}) — "
                             "the knob is unreachable without a code "
                             "edit"),
                    hint=("add the flag (and wire it in the config "
                          "builder), add a rename to tpucheck's "
                          "_FLAG_ALIASES, or baseline with the reason "
                          "it is deliberately not CLI-wired"),
                    key=f"{cls}.{fname}:cli"))
            mentions = [fname] + wired + ([alias] if alias else [])
            pattern = "|".join(re.escape(m) for m in mentions if m)
            if not re.search(pattern, docs_text):
                findings.append(Finding(
                    rule="R5", path=path, line=line,
                    message=(f"{cls}.{fname} is mentioned nowhere in "
                             "README.md or docs/ (neither the field "
                             "name nor its flag)"),
                    hint=("document the knob where its subsystem is "
                          "described (docs/static_analysis.md is "
                          "excluded from this check on purpose)"),
                    key=f"{cls}.{fname}:docs"))
        return findings
