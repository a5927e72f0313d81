"""tpucheck core: file discovery, parsed sources, findings, rule runner.

A copy of ``tpunet/analysis/core.py`` whose default roots are the
port's own code. Stdlib-only on purpose (``ast`` + ``re``): the checker
must run in a bare container, before torch imports, and on fixture
trees that are not importable packages. Rules therefore work on
syntax, not on live objects.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: Inline escape hatch: ``# tpucheck: disable=R1`` (or ``R1,R4`` or
#: ``all``) on the finding's line or the line directly above it.
_SUPPRESS_RE = re.compile(r"#\s*tpucheck:\s*disable=([A-Za-z0-9_,]+|all)")


@dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id + location + stable identity.

    ``key`` is the baseline-matching identity — it must NOT contain
    line numbers, so accepted findings survive unrelated edits above
    them. ``message`` says what is wrong; ``hint`` says how to fix it.
    """

    rule: str
    path: str               # repo-relative, posix separators
    line: int
    message: str
    hint: str = ""
    key: str = ""

    def identity(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.key or self.message)

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "key": self.key}


class SourceFile:
    """One python file: source text, lines, AST, suppression map."""

    def __init__(self, abs_path: str, rel_path: str) -> None:
        self.abs_path = abs_path
        self.rel = rel_path.replace(os.sep, "/")
        with open(abs_path, "r", encoding="utf-8", errors="replace") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.source, filename=self.rel)
        except SyntaxError as e:  # surfaced as a finding by run_rules
            self.parse_error = f"{e.msg} (line {e.lineno})"
        # line -> (rules, standalone): a TRAILING comment suppresses
        # its own line only; a comment-ONLY line suppresses the next.
        self._suppress: Dict[int, Tuple[Set[str], bool]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                spec = m.group(1)
                rules = ({"all"} if spec == "all"
                         else {r.strip().upper()
                               for r in spec.split(",") if r.strip()})
                self._suppress[i] = (rules, text.lstrip().startswith("#"))

    def suppressed(self, rule: str, line: int) -> bool:
        """True when ``line`` carries a trailing ``# tpucheck:
        disable=`` comment naming this rule, or the line directly
        above is a standalone one."""
        for ln, need_standalone in ((line, False), (line - 1, True)):
            entry = self._suppress.get(ln)
            if entry is None:
                continue
            rules, standalone = entry
            if need_standalone and not standalone:
                continue
            if "all" in rules or rule.upper() in rules:
                return True
        return False


class Project:
    """The file set one tpucheck run analyzes.

    ``root`` is a repo (or fixture) directory; files are discovered
    under ``roots`` — by default the port's production code only
    (``tests/`` and fixture trees are never analyzed: test files
    legitimately spawn raw threads). A root may be a glob
    (``scripts/torch_*.py``).
    """

    DEFAULT_ROOTS: Tuple[str, ...] = ("tpunet_torch", "chip_smoke.py",
                                      "scripts/torch_*.py")
    EXCLUDE_DIR_PARTS: Tuple[str, ...] = ("__pycache__", "_lib",
                                          "fixtures", ".git")

    def __init__(self, root: str,
                 roots: Optional[Sequence[str]] = None) -> None:
        self.root = os.path.abspath(root)
        self.roots: Tuple[str, ...] = tuple(roots or self.DEFAULT_ROOTS)
        self._files: Optional[List[SourceFile]] = None
        self._mds: Optional[List[Tuple[str, str]]] = None

    def _excluded(self, rel: str) -> bool:
        parts = rel.replace(os.sep, "/").split("/")
        return any(p in self.EXCLUDE_DIR_PARTS for p in parts)

    def files(self) -> List[SourceFile]:
        """All analyzed python files, parsed, sorted by path."""
        if self._files is not None:
            return self._files
        found: List[SourceFile] = []
        paths: List[str] = []
        for entry in self.roots:
            if glob.has_magic(entry):
                paths += sorted(glob.glob(os.path.join(self.root, entry)))
            else:
                paths.append(os.path.join(self.root, entry))
        for path in paths:
            if os.path.isfile(path) and path.endswith(".py"):
                found.append(SourceFile(path,
                                        os.path.relpath(path, self.root)))
                continue
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames
                               if d not in self.EXCLUDE_DIR_PARTS]
                for name in sorted(filenames):
                    if not name.endswith(".py"):
                        continue
                    abs_path = os.path.join(dirpath, name)
                    rel = os.path.relpath(abs_path, self.root)
                    if not self._excluded(rel):
                        found.append(SourceFile(abs_path, rel))
        found.sort(key=lambda f: f.rel)
        self._files = found
        return found

    def md_files(self) -> List[Tuple[str, str]]:
        """(rel path, text) of README.md and docs/ markdown files —
        the corpus R5's docs-mention check searches. The other
        root-level notes (change logs, roadmaps, issues) are not user
        docs, so a mention there does not count."""
        if self._mds is not None:
            return self._mds
        out: List[Tuple[str, str]] = []
        candidates: List[str] = []
        if os.path.isfile(os.path.join(self.root, "README.md")):
            candidates.append("README.md")
        docs = os.path.join(self.root, "docs")
        if os.path.isdir(docs):
            for name in sorted(os.listdir(docs)):
                if name.endswith(".md"):
                    candidates.append(os.path.join("docs", name))
        for rel in candidates:
            with open(os.path.join(self.root, rel), "r",
                      encoding="utf-8", errors="replace") as f:
                out.append((rel.replace(os.sep, "/"), f.read()))
        self._mds = out
        return out


class Rule:
    """A tpucheck rule: stable ``id`` (R1..), short ``name``, and a
    ``run`` over a Project returning findings (unsuppressed filtering
    and sorting belong to ``run_rules``, not the rule)."""

    id: str = ""
    name: str = ""
    doc: str = ""

    def run(self, project: Project) -> List[Finding]:
        raise NotImplementedError


def dotted(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('jax.jit',
    'self.ckpt.restore_state'); '' for anything else."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call):
        # functools.partial(jax.jit, ...)(f) style chains: fold the
        # callee in so suffix matching still works.
        inner = dotted(cur.func)
        if inner:
            parts.append(inner)
        else:
            return ""
    else:
        return ""
    return ".".join(reversed(parts))


def call_name(node: ast.Call) -> str:
    return dotted(node.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def run_rules(project: Project, rules: Sequence[Rule]) -> List[Finding]:
    """Run rules, drop inline-suppressed findings, sort by location.

    Unparseable files produce one synthetic finding each (rule id
    ``PARSE``) instead of being silently skipped — a checker that
    skips broken files reads as 'clean' exactly when the tree is not.
    """
    findings: List[Finding] = []
    by_rel = {f.rel: f for f in project.files()}
    for src in project.files():
        if src.parse_error is not None:
            findings.append(Finding(
                rule="PARSE", path=src.rel, line=1,
                message=f"file does not parse: {src.parse_error}",
                key=f"parse:{src.rel}"))
    seen: Set[Tuple[str, str, int, str, str]] = set()
    for rule in rules:
        for finding in rule.run(project):
            src = by_rel.get(finding.path)
            if src is not None and src.suppressed(finding.rule,
                                                  finding.line):
                continue
            ident = (finding.rule, finding.path, finding.line,
                     finding.key, finding.message)
            if ident in seen:
                continue
            seen.add(ident)
            findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return findings
