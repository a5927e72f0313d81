"""The port's tpucheck CLI: ``python -m tpunet_torch.analysis`` (a copy
of ``python -m tpunet.analysis``; the rule catalog is this package's
docstring).

Exit codes: 0 = clean (or every finding baselined), 1 = new findings
(or stale baseline entries under ``--strict-baseline``), 2 = usage or
internal error. ``--write-baseline`` accepts the current findings into
the ledger (preserving existing justifications; new entries get a
``TODO: justify`` a human must replace before the baseline loads).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from tpunet_torch.analysis import baseline as baseline_mod
from tpunet_torch.analysis.core import Project, run_rules
from tpunet_torch.analysis.rules import ALL_RULES, rules_by_id

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join("tpunet_torch", "analysis", "baseline.json")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpunet_torch.analysis",
        description="tpucheck: the port's static analysis (rule "
                    "catalog in tpunet_torch/analysis/__init__.py)")
    p.add_argument("--root", default=_REPO_ROOT,
                   help="tree to analyze (default: this repo)")
    p.add_argument("--baseline", default=None, metavar="PATH|none",
                   help="accepted-findings ledger (default: "
                        f"<root>/{DEFAULT_BASELINE}; 'none' disables)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept the current findings into the baseline "
                        "(existing justifications preserved; new "
                        "entries need a human-written 'why')")
    p.add_argument("--rules", default=None, metavar="R1,R2",
                   help="comma-separated rule ids to run (default all)")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--strict-baseline", action="store_true",
                   help="stale baseline entries fail the run (fixed "
                        "code must shed its entry)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    by_id = rules_by_id()
    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id}  {rule.name}: {rule.doc}")
        return 0
    rules = list(ALL_RULES)
    if args.rules:
        wanted = [r.strip().upper() for r in args.rules.split(",")
                  if r.strip()]
        unknown = [w for w in wanted if w not in by_id]
        if unknown:
            print(f"tpucheck: unknown rule id(s): {', '.join(unknown)} "
                  f"(have {', '.join(by_id)})", file=sys.stderr)
            return 2
        rules = [by_id[w] for w in wanted]
    root = os.path.abspath(args.root)
    if not os.path.isdir(root):
        print(f"tpucheck: --root {root} is not a directory",
              file=sys.stderr)
        return 2

    project = Project(root)
    findings = run_rules(project, rules)

    baseline_path: Optional[str]
    if args.baseline == "none":
        baseline_path = None
    elif args.baseline is not None:
        baseline_path = args.baseline
    else:
        baseline_path = os.path.join(root, DEFAULT_BASELINE)
    try:
        bl = (baseline_mod.load(baseline_path) if baseline_path
              else baseline_mod.Baseline())
    except ValueError as e:
        print(f"tpucheck: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        if baseline_path is None:
            print("tpucheck: --write-baseline needs a baseline path",
                  file=sys.stderr)
            return 2
        todo = baseline_mod.write(baseline_path, findings, bl)
        print(f"tpucheck: wrote {len(findings)} entries to "
              f"{baseline_path}"
              + (f" ({todo} need a human-written 'why' before the "
                 "baseline will load)" if todo else ""))
        return 0

    new, accepted, stale = bl.split(findings)
    # A --rules subset run never produces other rules' findings; their
    # baseline entries are unevaluated, not stale.
    run_ids = {r.id for r in rules}
    stale = [e for e in stale if e["rule"] in run_ids]

    if args.json:
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in accepted],
            "stale_baseline_entries": stale,
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        for entry in stale:
            print(f"tpucheck: STALE baseline entry: {entry['rule']} "
                  f"{entry['path']} ({entry['key']}) — the finding no "
                  "longer occurs; drop the entry", file=sys.stderr)
        n_files = len(project.files())
        print(f"tpucheck: {len(new)} new finding(s), {len(accepted)} "
              f"baselined, {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} across {n_files} "
              f"files [{', '.join(r.id for r in rules)}]")
    if new:
        return 1
    if stale and args.strict_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
