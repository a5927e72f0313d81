"""R6 — metrics-schema instrument naming.

A copy of tpunet's R6 over ``tpunet_torch/``: the port writes the same
records (ROADMAP port rule 4), so its instruments answer to the same,
unedited ``docs/metrics_schema.md``.

``docs/metrics_schema.md`` is the contract every obs consumer reads,
and ``scripts/check_metrics_schema.py`` enforces it for *records* —
but only for the emission paths the check drives, at runtime. An
instrument created with ``registry.counter("new_thing_total")`` in a
path the check never exercises drifts in silently: the gauge ships to
exporters and shows up in ``GET /metrics`` with no documentation
anywhere. This rule closes that gap statically: every literal
``.counter(...)`` / ``.gauge(...)`` / ``.histogram(...)`` name in
``tpunet_torch/`` must appear in docs/metrics_schema.md; f-string names
(``f"export_{name}_dropped"``) must match a documented placeholder
pattern (``export_<name>_dropped``).

Scope is ``tpunet_torch/`` only: scripts drive fake instruments on purpose
(check_metrics_schema's ``some_gauge``), and tests are never
analyzed. Names passed as variables are out of reach for a syntax
checker — the runtime schema check still covers the records those
feed.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional, Set, Tuple

from tpunet_torch.analysis.core import Finding, Project, Rule, const_str

SCHEMA_DOC = "docs/metrics_schema.md"

_METHODS = ("counter", "gauge", "histogram")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_PLACEHOLDER = re.compile(r"<[^<>]+>")
#: Stand-in for an f-string's formatted values when probing doc
#: patterns: any placeholder must cover it.
_PROBE = "X0"


def _expand_braces(text: str) -> Iterator[str]:
    """``ttft_{p50,p90}_s`` -> ttft_p50_s, ttft_p90_s (one level,
    mirroring check_metrics_schema's schema parser)."""
    m = re.search(r"\{([^{}]*)\}", text)
    if not m:
        yield text
        return
    for alt in m.group(1).split(","):
        yield from _expand_braces(text[:m.start()] + alt.strip()
                                  + text[m.end():])


def parse_schema_names(text: str) -> Tuple[Set[str], List[re.Pattern]]:
    """(literal identifier tokens, placeholder patterns) from every
    backticked span of the schema doc. ``export_<name>_dropped``
    becomes a regex whose ``<...>`` holes match any identifier run —
    the documented shape for dynamically-named instrument families."""
    literals: Set[str] = set()
    patterns: List[re.Pattern] = []
    for span in re.findall(r"`([^`]+)`", text):
        for expanded in _expand_braces(span):
            if "<" in expanded:
                for piece in expanded.split():
                    if "<" not in piece:
                        continue
                    stripped = _PLACEHOLDER.sub("\x00", piece)
                    if not _IDENT.search(stripped.replace("\x00", "")):
                        # A bare `<name>` span has no literal anchor:
                        # compiling it would yield a match-everything
                        # wildcard that silences the whole rule.
                        continue
                    rx = (re.escape(stripped)
                          .replace(re.escape("\x00"), "[A-Za-z0-9_]+")
                          .replace("\x00", "[A-Za-z0-9_]+"))
                    try:
                        patterns.append(re.compile(rx + r"\Z"))
                    except re.error:
                        continue
            else:
                literals.update(_IDENT.findall(expanded))
    return literals, patterns


def _probe_name(arg: ast.AST) -> Optional[Tuple[str, bool]]:
    """(name-or-probe, is_dynamic) for an instrument-name argument:
    a constant string verbatim, an f-string with formatted values
    replaced by a probe token, None for anything else (variables —
    out of static reach)."""
    s = const_str(arg)
    if s is not None:
        return s, False
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for v in arg.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append(_PROBE)
        return "".join(parts), True
    return None


class InstrumentRule(Rule):
    id = "R6"
    name = "metrics-schema-instruments"
    doc = ("every literal registry.counter/gauge/histogram name in "
           "tpunet_torch/ is documented in docs/metrics_schema.md")

    def run(self, project: Project) -> List[Finding]:
        schema_text = ""
        for rel, text in project.md_files():
            if rel == SCHEMA_DOC:
                schema_text = text
                break
        literals, patterns = parse_schema_names(schema_text)

        findings: List[Finding] = []
        for src in project.files():
            if src.tree is None \
                    or not src.rel.startswith("tpunet_torch/"):
                continue
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call) \
                        or not isinstance(node.func, ast.Attribute) \
                        or node.func.attr not in _METHODS \
                        or not node.args:
                    continue
                probe = _probe_name(node.args[0])
                if probe is None:
                    continue
                name, dynamic = probe
                if not dynamic and name in literals:
                    continue
                if any(p.match(name) for p in patterns):
                    continue
                shown = (name.replace(_PROBE, "<...>")
                         if dynamic else name)
                findings.append(Finding(
                    rule="R6", path=src.rel, line=node.lineno,
                    message=(f"instrument {shown!r} "
                             f"({node.func.attr}) is not documented "
                             f"in {SCHEMA_DOC}"),
                    hint=("add the name to the schema doc (the "
                          "'Registry instruments' list or the record "
                          "kind that carries it); dynamic families "
                          "document their shape as name_<hole>_suffix"),
                    key=f"instrument:{shown}"))
        return findings
