"""R4 — thread-registry enforcement for host thread/process spawns.

A copy of tpunet's R4 over ``tpunet_torch/``. The host-thread registry
(``tpunet_torch/obs/flightrec/threads.py``, tpunet's by copy) exists
because background threads used to be invisible: no inventory
in crash reports, no liveness gauges, no ``thread_stalled`` paging.
That only holds if every spawn actually registers — one forgotten
``threading.Thread`` and the next wedged-process postmortem is back
to guessing. This rule makes registration structural: every
``threading.Thread(...)`` / ``subprocess.Popen(...)`` in ``tpunet_torch/``
must sit in a scope (enclosing class, else enclosing function, else
module) that references the flightrec registry (``register_thread``
or ``THREADS``), or be explicitly allowlisted.

Scope granularity is the class on purpose: the idiom is "register in
``__init__``/``start``, beat in ``_run``" — the registration and the
spawn are different methods of one object.

``subprocess.run`` is deliberately NOT flagged: it is synchronous
(the child is reaped before the call returns), so there is nothing
long-lived to inventory. The flight recorder's own plumbing
(``tpunet_torch/obs/flightrec/``) is allowlisted — the watcher subprocess
is the thing that reports on everyone else and cannot register with
itself.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from tpunet_torch.analysis.core import (Finding, Project, Rule,
                                        call_name, const_str)

_SPAWN_SUFFIXES = {"threading.Thread": "thread", "Thread": "thread",
                   "subprocess.Popen": "process", "Popen": "process"}

#: Paths (prefix match on the repo-relative posix path) where spawns
#: are the registry's own machinery — or, for the elastic agent, a
#: deliberately torch-free supervisor process: the agent launches and
#: reaps the trainer children that HOST the registry; it has no obs
#: runtime of its own to register with, and its supervise loop (poll
#: + heartbeat files) is its own inventory.
_ALLOWLIST_PREFIXES = ("tpunet_torch/obs/flightrec/",
                       "tpunet_torch/elastic/agent.py")

_REGISTRY_NAMES = {"register_thread", "THREADS"}


def _scope_chain(tree: ast.AST) -> List[Tuple[ast.AST, ast.AST]]:
    """(node, enclosing scope node) for every Call, where scope is the
    nearest ClassDef if any, else nearest FunctionDef, else module."""
    out: List[Tuple[ast.AST, ast.AST]] = []

    def walk(node: ast.AST, cls: Optional[ast.AST],
             fn: Optional[ast.AST], module: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            next_cls, next_fn = cls, fn
            if isinstance(child, ast.ClassDef):
                next_cls, next_fn = child, None
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                next_fn = child
            if isinstance(child, ast.Call):
                out.append((child, cls or fn or module))
            walk(child, next_cls, next_fn, module)

    walk(tree, None, None, tree)
    return out


def _references_registry(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if isinstance(node, ast.Name) and node.id in _REGISTRY_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _REGISTRY_NAMES:
            return True
        if isinstance(node, ast.ImportFrom):
            if any(a.name in _REGISTRY_NAMES for a in node.names):
                return True
    return False


class ThreadRule(Rule):
    id = "R4"
    name = "thread-registry"
    doc = ("every threading.Thread/subprocess.Popen spawn in "
           "tpunet_torch/ "
           "registers with the flightrec THREADS registry or is "
           "allowlisted")

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for src in project.files():
            if src.tree is None:
                continue
            if not src.rel.startswith("tpunet_torch/"):
                continue
            if src.rel.startswith(_ALLOWLIST_PREFIXES):
                continue
            for call, scope in _scope_chain(src.tree):
                kind = _SPAWN_SUFFIXES.get(call_name(call))
                if kind is None:
                    continue
                if _references_registry(scope):
                    continue
                scope_name = getattr(scope, "name", "<module>")
                spawn_name = ""
                for kw in call.keywords:
                    if kw.arg == "name":
                        spawn_name = const_str(kw.value) or ""
                detail = spawn_name or f"in {scope_name}"
                findings.append(Finding(
                    rule="R4", path=src.rel, line=call.lineno,
                    message=(f"{kind} spawn ({detail}) does not register "
                             "with the flightrec host-thread registry — "
                             "it will be invisible to crash reports, "
                             "thread_* gauges, and the thread_stalled "
                             "watchdog"),
                    hint=("handle = flightrec.register_thread(\"<name>\""
                          ", stall_after_s=...) next to the spawn and "
                          "beat busy/idle around blocking work; "
                          "genuinely unmanaged spawns go in the "
                          "baseline with a justification"),
                    key=f"{kind}:{scope_name}:{spawn_name or 'anon'}"))
        return findings
