"""R2 — kernel-launch coverage, the port's counterpart of tpunet's R2.

tpunet's R2 keeps the Pallas kernels' phase attribution from rotting
silently. The port's invariant that plays that role is ROADMAP's port
rule 3 plus the launch counters that ``chip_smoke.py`` reads to show
that a main path went through its kernels: a CUDA tensor launches the
kernel or raises, and each launch counts once. Three ways to break it
one innocent edit at a time, each caught here for every call of a
kernel loaded through ``tpunet_torch/ops/_build.py`` inside
``tpunet_torch/ops/``:

- **unchecked** — the C entry's returned error code is not checked and
  raised on in the calling function (a failed launch would return
  uninitialised memory as a result);
- **uncounted** — the calling function does not bump a wrapper's
  ``.launches`` counter (the launch is invisible to the chip check);
- **swallowed** — the call sits in a ``try`` body whose handler carries
  on instead of raising (a fallback around the kernel);
- **env** — the calling function reads ``os.environ`` (an environment
  switch around the kernel).

A kernel entry is whatever a *loader* returns: a function of the module
whose body calls ``_build.load(...)``. Calls are recognised as
``loader(...)(...)``, ``loader(...)[i](...)``, a name bound from either
in the same function, or an attribute of a ``_build.load(...)`` value.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from tpunet_torch.analysis.core import Finding, Project, Rule, call_name

OPS_PREFIX = "tpunet_torch/ops/"

_HINT = {
    "unchecked": ("assign the entry's return code and raise on a non-zero "
                  "code in the same function (ops/depthwise.py "
                  "_launch_bwd is the pattern)"),
    "uncounted": ("bump the wrapper's counter (``wrapper.launches += 1``) "
                  "after the checked launch, in the same function"),
    "swallowed": ("a CUDA tensor launches the kernel or raises (port rule "
                  "3): let the error propagate, or re-raise it"),
    "env": ("no environment variable decides whether the kernel runs "
            "(port rule 3): take the setting as an argument"),
}

_MESSAGE = {
    "unchecked": "its return code is not checked and raised on here",
    "uncounted": "this function bumps no ``.launches`` counter",
    "swallowed": "it sits in a try body whose handler carries on",
    "env": "this function reads os.environ",
}


def _loaders(tree: ast.AST) -> Set[str]:
    """Names of the module's functions that call ``_build.load``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and call_name(sub).endswith("_build.load"):
                    out.add(node.name)
                    break
    return out


def _own_nodes(fn: ast.AST) -> List[ast.AST]:
    """Nodes of ``fn``'s body that no nested function or class owns."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _is_entry(node: ast.AST, loaders: Set[str], bound: Set[str],
              libs: Set[str]) -> bool:
    """True when ``node`` evaluates to a kernel entry."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Call):
        name = call_name(node)
        return name in loaders
    if isinstance(node, ast.Name):
        return node.id in bound
    if isinstance(node, ast.Attribute):
        base = node.value
        if isinstance(base, ast.Call):
            return call_name(base).endswith("_build.load")
        return isinstance(base, ast.Name) and base.id in libs
    return False


def _reads_environ(nodes: List[ast.AST]) -> bool:
    for node in nodes:
        if isinstance(node, ast.Attribute) and node.attr == "environ":
            return True
        if isinstance(node, ast.Call) \
                and call_name(node).rsplit(".", 1)[-1] == "getenv":
            return True
    return False


def _carries_on(handler: ast.ExceptHandler) -> bool:
    return not any(isinstance(n, ast.Raise) for n in ast.walk(handler))


class LaunchRule(Rule):
    id = "R2"
    name = "kernel-launches"
    doc = ("every kernel call in tpunet_torch/ops/ checks and raises on "
           "its return code and bumps a .launches counter in the same "
           "function, with no try that carries on and no os.environ")

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for src in project.files():
            if src.tree is None or not src.rel.startswith(OPS_PREFIX):
                continue
            loaders = _loaders(src.tree)
            for fn in ast.walk(src.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                findings += self._check(src.rel, fn, loaders)
        return findings

    def _check(self, rel: str, fn: ast.AST,
               loaders: Set[str]) -> List[Finding]:
        nodes = _own_nodes(fn)
        bound: Set[str] = set()
        libs: Set[str] = set()
        # Names bound from an entry or a loaded library, in source order
        # (one pass suffices: a binding precedes its use).
        for node in sorted((n for n in nodes if isinstance(n, ast.Assign)),
                           key=lambda n: (n.lineno, n.col_offset)):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if isinstance(node.value, ast.Call) \
                    and call_name(node.value).endswith("_build.load"):
                libs.update(targets)
            elif _is_entry(node.value, loaders, bound, libs):
                bound.update(targets)
        calls = [n for n in nodes if isinstance(n, ast.Call)
                 and _is_entry(n.func, loaders, bound, libs)]
        if not calls:
            return []
        parent: Dict[ast.AST, ast.AST] = {}
        for node in [fn] + nodes:
            for child in ast.iter_child_nodes(node):
                parent[child] = node
        counted = any(isinstance(n, ast.AugAssign)
                      and isinstance(n.target, ast.Attribute)
                      and n.target.attr == "launches" for n in nodes)
        env = _reads_environ(nodes)
        out: List[Finding] = []
        for call in calls:
            kinds = []
            if not self._checked(call, nodes, parent):
                kinds.append("unchecked")
            if not counted:
                kinds.append("uncounted")
            if self._swallowed(call, parent):
                kinds.append("swallowed")
            if env:
                kinds.append("env")
            entry = call_name(call) or ast.unparse(call.func)
            for kind in kinds:
                out.append(Finding(
                    rule=self.id, path=rel, line=call.lineno,
                    message=(f"kernel call {entry}(...) in {fn.name}: "
                             f"{_MESSAGE[kind]}"),
                    hint=_HINT[kind], key=f"{kind}:{fn.name}"))
        return out

    @staticmethod
    def _checked(call: ast.Call, nodes: List[ast.AST],
                 parent: Dict[ast.AST, ast.AST]) -> bool:
        """The call's result is assigned to a name that an ``if`` of the
        same function tests and raises under."""
        up: Optional[ast.AST] = parent.get(call)
        if not isinstance(up, ast.Assign):
            return False
        names = {t.id for t in up.targets if isinstance(t, ast.Name)}
        for node in nodes:
            if not isinstance(node, ast.If):
                continue
            tested = {n.id for n in ast.walk(node.test)
                      if isinstance(n, ast.Name)}
            if tested & names and any(isinstance(n, ast.Raise)
                                      for s in node.body
                                      for n in ast.walk(s)):
                return True
        return False

    @staticmethod
    def _swallowed(call: ast.Call, parent: Dict[ast.AST, ast.AST]) -> bool:
        child: ast.AST = call
        node = parent.get(call)
        while node is not None:
            if isinstance(node, ast.Try) and child in node.body \
                    and any(_carries_on(h) for h in node.handlers):
                return True
            child, node = node, parent.get(node)
        return False
