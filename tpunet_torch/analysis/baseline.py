"""tpucheck baseline: accepted findings, each with a justification.

A copy of ``tpunet/analysis/baseline.py``. The port's baseline
(``tpunet_torch/analysis/baseline.json``) is the reviewed debt
ledger: a finding listed there is *intentionally kept*, and the entry
says why in one line. Matching is on ``(rule, path, key)`` — keys are
rule-generated stable identities with no line numbers in them, so an
accepted finding survives unrelated edits to the same file but a NEW
instance of the same rule in the same file still fails the gate.

Two staleness guarantees keep the ledger honest:

- an entry whose finding no longer occurs is reported as *stale*
  (fixed code must shed its baseline entry in the same change);
- ``--write-baseline`` regenerates entries from the current findings
  but preserves the ``why`` of entries that still match, and refuses
  to invent justifications (new entries get ``TODO: justify`` which
  the loader rejects — a human must write the reason).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from tpunet_torch.analysis.core import Finding

VERSION = 1
TODO_WHY = "TODO: justify"


@dataclass
class Baseline:
    """In-memory baseline: entries keyed by finding identity."""

    path: str = ""
    entries: List[Dict[str, str]] = field(default_factory=list)

    def _index(self) -> Dict[Tuple[str, str, str], Dict[str, str]]:
        return {(e["rule"], e["path"], e["key"]): e for e in self.entries}

    def matches(self, finding: Finding) -> bool:
        return finding.identity() in self._index()

    def split(self, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[Dict[str, str]]]:
        """(new, accepted, stale_entries) for a findings list."""
        index = self._index()
        new: List[Finding] = []
        accepted: List[Finding] = []
        seen: Set[Tuple[str, str, str]] = set()
        for f in findings:
            ident = f.identity()
            if ident in index:
                accepted.append(f)
                seen.add(ident)
            else:
                new.append(f)
        stale = [e for key, e in index.items() if key not in seen]
        return new, accepted, stale


def load(path: str) -> Baseline:
    """Load a baseline file; loudly reject malformed or unjustified
    entries (an unjustified suppression is not a suppression)."""
    if not os.path.exists(path):
        return Baseline(path=path)
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != VERSION:
        raise ValueError(f"{path}: expected a tpucheck baseline with "
                         f"version {VERSION}")
    entries = data.get("entries", [])
    for e in entries:
        for req in ("rule", "path", "key", "why"):
            if not isinstance(e.get(req), str) or not e[req].strip():
                raise ValueError(f"{path}: baseline entry missing "
                                 f"'{req}': {e!r}")
        if e["why"] == TODO_WHY:
            raise ValueError(
                f"{path}: entry for {e['rule']} {e['path']} ({e['key']}) "
                f"still says '{TODO_WHY}' — write the one-line reason "
                "this finding is intentionally kept")
    return Baseline(path=path, entries=list(entries))


def write(path: str, findings: Sequence[Finding],
          previous: Baseline) -> int:
    """Write a baseline covering ``findings``, preserving the ``why``
    of still-matching entries from ``previous``. Returns the number of
    entries that need a human-written justification."""
    prev = previous._index()
    entries: List[Dict[str, str]] = []
    todo = 0
    for f in findings:
        old = prev.get(f.identity())
        why = old["why"] if old else TODO_WHY
        if why == TODO_WHY:
            todo += 1
        entries.append({"rule": f.rule, "path": f.path, "key": f.key
                        or f.message, "why": why,
                        "message": f.message})
    payload = {
        "_comment": [
            "The port's tpucheck accepted-findings ledger",
            "(python -m tpunet_torch.analysis; rules in its __init__).",
            "Every entry is an intentionally-kept finding; 'why' is the",
            "one-line review justification. Matching is (rule, path,",
            "key) - stable across line drift. Fixed code must drop its",
            "entry (stale entries are reported).",
        ],
        "version": VERSION,
        "entries": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return todo
