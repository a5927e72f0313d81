"""Cross-run regression gate: compare two runs, exit-coded like the

The port's copy of ``scripts/obs_compare.py``: the same flags and the
same output, importing no JAX.
budget gates.

    # compare two run dirs (each containing metrics.jsonl)
    python -m tpunet_torch.obs.cli.compare runs/baseline/ runs/candidate/

    # keep (and reuse) summaries in a run-history index
    python -m tpunet_torch.obs.cli.compare A/ B/ --history history-dir/

    # page a webhook on a regression verdict, emit the record to a
    # metrics file, or print the full record as JSON
    python -m tpunet_torch.obs.cli.compare A/ B/ --webhook http://pager/hook
    python -m tpunet_torch.obs.cli.compare A/ B/ --emit out/metrics.jsonl
    python -m tpunet_torch.obs.cli.compare A/ B/ --json

Verdicts come from ``tpunet_torch/obs/history/compare.py``: runs align on
their overlapping global-step range and every step-time / serve-SLO
quantile is judged against BOTH runs' DKW rank-error bounds — a
``regression`` verdict means disjoint confidence intervals, never a
wobble inside the bars. Exact scalars (throughput, MFU) use
``--tolerance`` (default 0.05) instead.

Exit codes (budget-gate convention): 0 = ok / within error,
3 = regression, 2 = usage error or incomparable runs (different
config fingerprints without --allow-fingerprint-mismatch, or no
overlapping sample data). Output is deterministic for fixed inputs —
same run dirs, same verdict, byte for byte.
"""

from __future__ import annotations

import json
import os
import sys

from tpunet_torch.obs.cli._flags import split_flags

VALUE_FLAGS = ("--history", "--tolerance", "--webhook", "--emit")
BOOL_FLAGS = ("--json", "--allow-fingerprint-mismatch")


def _summarize(path: str, history):
    from tpunet_torch.obs.history import summarize_run
    from tpunet_torch.utils.logging import MetricsLogger

    if history is not None:
        return history.ingest_run(path)
    metrics = (path if path.endswith(".jsonl")
               else os.path.join(path, "metrics.jsonl"))
    if not os.path.isfile(metrics):
        raise FileNotFoundError(f"no metrics.jsonl under {path!r}")
    return summarize_run(MetricsLogger.read_records(metrics),
                         source=path)


def _render(cmp: dict) -> str:
    out = [f"obs_compare: {cmp['run_a']} (baseline) vs "
           f"{cmp['run_b']} (candidate)"]
    if cmp.get("step_lo") is not None:
        out.append(f"  aligned steps [{cmp['step_lo']}, "
                   f"{cmp['step_hi']}] — windows "
                   f"{cmp['windows_a']}/{cmp['windows_b']}")
    for m in cmp.get("metrics", []):
        bar = ""
        if "a_lo" in m:
            bar = (f"  [{m['a_lo']:.6g}, {m['a_hi']:.6g}] vs "
                   f"[{m['b_lo']:.6g}, {m['b_hi']:.6g}]")
        elif "tolerance" in m:
            bar = f"  (tolerance {m['tolerance']:g})"
        frac = (f"{100 * m['delta_frac']:+.1f}%"
                if m.get("delta_frac") is not None else "n/a")
        out.append(f"  {m['verdict']:>12}  {m['metric']:<22} "
                   f"{m['a']:.6g} -> {m['b']:.6g} ({frac}){bar}")
    out.append(f"verdict: {cmp['verdict'].upper()} "
               f"({cmp.get('regressions', 0)} regression(s), "
               f"{cmp.get('improvements', 0)} improvement(s))")
    return "\n".join(out)


def main(argv=None) -> int:
    parsed = split_flags(sys.argv[1:] if argv is None else argv,
                         VALUE_FLAGS, BOOL_FLAGS)
    if isinstance(parsed, int):
        return parsed
    flags, paths = parsed
    if len(paths) != 2:
        print("usage: obs_compare.py RUN_A RUN_B [--history DIR] "
              "[--tolerance F] [--webhook URL] [--emit PATH] [--json] "
              "[--allow-fingerprint-mismatch]", file=sys.stderr)
        return 2
    try:
        tolerance = float(flags.get("tolerance", 0.05))
    except ValueError:
        print(f"--tolerance expects a float, got "
              f"{flags['tolerance']!r}", file=sys.stderr)
        return 2

    from tpunet_torch.obs.history import RunHistory, compare_summaries

    history = (RunHistory(str(flags["history"]))
               if "history" in flags else None)
    try:
        a = _summarize(paths[0], history)
        b = _summarize(paths[1], history)
    except (FileNotFoundError, ValueError) as e:
        print(f"obs_compare: {e}", file=sys.stderr)
        return 2
    cmp = compare_summaries(a, b, tolerance=tolerance)

    if cmp.get("fingerprint_match") is False \
            and "allow-fingerprint-mismatch" not in flags:
        print(f"obs_compare: config fingerprints differ "
              f"({a.get('config_fingerprint')} vs "
              f"{b.get('config_fingerprint')}) — these runs computed "
              "different workloads; comparing them would call a "
              "config change a regression. Pass "
              "--allow-fingerprint-mismatch to compare anyway.",
              file=sys.stderr)
        return 2

    if "json" in flags:
        print(json.dumps(cmp, indent=1, sort_keys=True))
    else:
        print(_render(cmp))

    # Optional emission: the obs_regression record reaches a metrics
    # file and/or pages the webhook — the same record body either way.
    if "emit" in flags or "webhook" in flags:
        from tpunet_torch.obs.registry import Registry
        reg = Registry()
        webhook = None
        if "emit" in flags:
            path = str(flags["emit"])

            class _FileSink:
                def write(self, record):
                    with open(path, "a") as f:
                        f.write(json.dumps(record) + "\n")

            reg.add_sink(_FileSink())
        if "webhook" in flags:
            from tpunet_torch.obs.export import AlertWebhook
            webhook = AlertWebhook(str(flags["webhook"]), registry=reg)
            reg.add_sink(webhook)
        from tpunet_torch.obs.history import emit_regression
        emit_regression(reg, cmp)
        if webhook is not None:
            webhook.close()
            st = webhook.stats()
            if st["send_errors"] or st["dropped"]:
                print(f"obs_compare: webhook delivery incomplete: {st}",
                      file=sys.stderr)

    if cmp["verdict"] == "regression":
        return 3
    if cmp["verdict"] == "incomparable":
        print("obs_compare: no overlapping sample data — nothing to "
              "judge", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
