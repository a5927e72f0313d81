"""Live terminal dashboard over the tpunet obs record stream.

The port's copy of ``scripts/obs_dashboard.py``: the same flags and the
same output, importing no JAX.

Single-run modes, one renderer (``tpunet_torch.obs.summary.summarize`` —
the same summarizer ``obs_report.py`` uses, so live and post-mortem
views can never disagree):

    # live-tail a run's metrics.jsonl (follows appends; tolerates the
    # torn trailing line a crash or an in-flight write leaves)
    python -m tpunet_torch.obs.cli.dashboard checkpoints/

    # one render, no follow loop (CI / scripting)
    python -m tpunet_torch.obs.cli.dashboard checkpoints/ --once

    # receive line-JSON POSTs from a run started with
    #   train.py --obs-http http://HOST:8321/
    python -m tpunet_torch.obs.cli.dashboard --listen 8321

Fleet mode (``tpunet_torch.obs.agg``) merges N streams into one view —
give several metrics.jsonl paths (tailed/replayed side by side), or
``--listen --fleet`` to route concurrent POSTs from many runs by
their ``run_id``/``process_index`` identity stamps:

    python -m tpunet_torch.obs.cli.dashboard runA/ runB/ --once --html fleet.html
    python -m tpunet_torch.obs.cli.dashboard --listen 8321 --fleet --stale-after 60

The fleet view shows exact merged counts/means, bounded-error merged
percentiles, the step-aligned straggler factor, per-stream rows, the
aggregated serve SLO panel (fleet TTFT/e2e, total queue depth,
per-replica reject rates), and fleet alerts (straggler / stale stream
/ memory growth / ``--rule`` GaugePredicates).

``--html report.html`` writes a self-contained static report (stat
tiles, SVG charts, alert and epoch tables; light/dark via CSS custom
properties) instead of — or, in follow mode, alongside — the terminal
view. GET on the ``--listen`` port returns the current text render,
so ``curl :8321`` is a remote status line.
"""

from __future__ import annotations

import argparse
import html as html_mod
import json
import os
import sys
import threading
import time

SPARK = " ▁▂▃▄▅▆▇█"


def sparkline(values, width=32) -> str:
    """Unicode block sparkline, downsampled to ``width`` buckets."""
    vals = [v for v in values if v is not None]
    if not vals:
        return ""
    if len(vals) > width:
        per = -(-len(vals) // width)
        vals = [sum(vals[i:i + per]) / len(vals[i:i + per])
                for i in range(0, len(vals), per)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(SPARK[1 + int((v - lo) / span * (len(SPARK) - 2))]
                   for v in vals)


def _fmt_rate(v) -> str:
    if v is None:
        return "-"
    return f"{v / 1e3:.1f}k" if v >= 10_000 else f"{v:.0f}"


# ---------------------------------------------------------------------------
# terminal view
# ---------------------------------------------------------------------------


def render_terminal(summary: dict, source: str, last: int = 10) -> str:
    """One full-screen text frame from a summarize() dict."""
    totals = summary["totals"]
    obs = summary["obs_epochs"]
    windows = summary["step_windows"]
    alerts = summary["alerts"]
    out = [f"tpunet obs dashboard — {source} — "
           f"{time.strftime('%H:%M:%S')}"]

    head = []
    if obs:
        r = obs[-1]
        head.append(f"epoch {r['epoch']} step {r.get('step', '?')}")
    thr = totals.get("tokens_per_sec", totals.get("examples_per_sec"))
    if thr is not None:
        unit = "tok/s" if "tokens_per_sec" in totals else "ex/s"
        head.append(f"{_fmt_rate(thr)} {unit}")
    if totals.get("mfu") is not None:
        head.append(f"MFU {totals['mfu']:.3f}")
    if "stall_frac" in totals:
        head.append(f"stall {100 * totals['stall_frac']:.1f}%")
    if totals.get("live_processes") is not None:
        head.append(f"procs {totals['live_processes']}")
    if totals.get("peak_bytes_in_use") is not None:
        head.append(f"mem {totals['peak_bytes_in_use'] / 2**30:.2f} GiB")
    if head:
        out.append("  ".join(head))
    out.append("")

    if alerts:
        out.append(f"ALERTS ({len(alerts)}):")
        for a in alerts[-5:]:
            out.append(f"  step {a.get('step', '?'):>8} "
                       f"[{a.get('severity', 'warn')}] "
                       f"{a.get('reason', '?')}")
        out.append("")

    if obs:
        out.append(f"{'ep':>4} {'steps':>6} {'p50ms':>8} {'p90ms':>8} "
                   f"{'p99ms':>8} {'stall%':>7} {'thruput':>9} {'mfu':>6}")
        for r in obs[-last:]:
            t = r.get("tokens_per_sec", r.get("examples_per_sec"))
            p50 = r.get("step_time_p50_s")
            p90 = r.get("step_time_p90_s")
            p99 = r.get("step_time_p99_s")
            mfu = r.get("mfu")
            out.append(
                f"{r['epoch']:>4} {r.get('steps', 0):>6} "
                f"{'-' if p50 is None else f'{p50 * 1e3:8.1f}'} "
                f"{'-' if p90 is None else f'{p90 * 1e3:8.1f}'} "
                f"{'-' if p99 is None else f'{p99 * 1e3:8.1f}'} "
                f"{100 * r.get('stall_frac', 0.0):>6.1f}% "
                f"{_fmt_rate(t):>9} "
                f"{'-' if mfu is None else f'{mfu:6.3f}'}")
        thr_series = [r.get("tokens_per_sec", r.get("examples_per_sec"))
                      for r in obs]
        spark = sparkline(thr_series)
        if spark:
            out.append(f"throughput/epoch  {spark}")
        out.append("")

    if windows:
        p50s = [w["step_time_p50_s"] for w in windows]
        out.append(f"step-time trend ({windows[0]['step_lo']}"
                   f"→{windows[-1]['step_hi']}, p50 per window): "
                   f"{sparkline(p50s)}")
        out.append(f"  first {p50s[0] * 1e3:.1f}ms  "
                   f"last {p50s[-1] * 1e3:.1f}ms  "
                   f"worst p99 {max(w['step_time_p99_s'] for w in windows) * 1e3:.1f}ms")

    if len(out) <= 3:
        out.append("waiting for records...")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# static HTML report
# ---------------------------------------------------------------------------

# Chart palette: the dataviz reference categorical slots 1-2 (blue,
# orange — adjacent-pair CVD-validated in both modes) plus the status
# red for alerts; text/surface tokens likewise, stepped per mode.
_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px; background: #fcfcfb; color: #0b0b0b;
  font: 14px/1.5 system-ui, -apple-system, sans-serif;
  --surface: #fcfcfb; --text-2: #52514e; --grid: #e8e7e3;
  --s1: #2a78d6; --s2: #eb6834; --s3: #7a57c9; --s4: #177c70;
  --s5: #a84f93; --bad: #e34948;
}
@media (prefers-color-scheme: dark) {
  body { background: #1a1a19; color: #fff;
         --surface: #1a1a19; --text-2: #c3c2b7; --grid: #343431;
         --s1: #3987e5; --s2: #d95926; --s3: #9678db; --s4: #2b9486;
         --s5: #c36bad; --bad: #e66767; }
}
h1 { font-size: 18px; margin: 0 0 4px; }
.sub { color: var(--text-2); margin: 0 0 20px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin: 0 0 24px; }
.tile { border: 1px solid var(--grid); border-radius: 8px;
        padding: 12px 16px; min-width: 110px; }
.tile .v { font-size: 22px; font-weight: 600; }
.tile .k { color: var(--text-2); font-size: 12px; }
.card { border: 1px solid var(--grid); border-radius: 8px;
        padding: 16px; margin: 0 0 20px; }
.card h2 { font-size: 14px; margin: 0 0 8px; }
.legend { color: var(--text-2); font-size: 12px; margin: 0 0 8px; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
              border-radius: 3px; vertical-align: -1px; margin-right: 4px; }
table { border-collapse: collapse; width: 100%; font-size: 13px; }
th { text-align: right; color: var(--text-2); font-weight: 500; }
th:first-child, td:first-child { text-align: left; }
td { text-align: right; }
th, td { padding: 4px 8px; border-bottom: 1px solid var(--grid); }
.alert { color: var(--bad); }
svg text { fill: var(--text-2); font-size: 11px; }
svg .gridline { stroke: var(--grid); stroke-width: 1; }
"""


def _svg_line_chart(series, width=640, height=180, fmt=lambda v: f"{v:g}"):
    """Minimal single-axis SVG line chart. ``series`` is a list of
    (css_color_var, label, [(x, y), ...]); one shared y scale, 2px
    lines, 8px hover targets with native <title> tooltips."""
    pad_l, pad_r, pad_t, pad_b = 48, 12, 8, 22
    pts = [p for _, _, ps in series for p in ps if p[1] is not None]
    if not pts:
        return ""
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x_lo, x_hi = min(xs), max(xs)
    y_lo, y_hi = min(ys), max(ys)
    if y_lo > 0 and y_lo < y_hi * 0.5:
        y_lo = 0.0              # near-zero floors: anchor at zero
    x_span = (x_hi - x_lo) or 1.0
    y_span = (y_hi - y_lo) or 1.0
    iw = width - pad_l - pad_r
    ih = height - pad_t - pad_b

    def sx(x):
        return pad_l + (x - x_lo) / x_span * iw

    def sy(y):
        return pad_t + ih - (y - y_lo) / y_span * ih

    parts = [f'<svg viewBox="0 0 {width} {height}" role="img" '
             f'style="width:100%;height:auto">']
    for frac in (0.0, 0.5, 1.0):
        y = pad_t + ih * frac
        val = y_hi - y_span * frac
        parts.append(f'<line class="gridline" x1="{pad_l}" y1="{y:.1f}" '
                     f'x2="{width - pad_r}" y2="{y:.1f}"/>')
        parts.append(f'<text x="{pad_l - 6}" y="{y + 4:.1f}" '
                     f'text-anchor="end">{fmt(val)}</text>')
    parts.append(f'<text x="{pad_l}" y="{height - 6}">{fmt_x(x_lo)}</text>')
    parts.append(f'<text x="{width - pad_r}" y="{height - 6}" '
                 f'text-anchor="end">{fmt_x(x_hi)}</text>')
    for color, label, ps in series:
        ps = [p for p in ps if p[1] is not None]
        if not ps:
            continue
        d = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in ps)
        parts.append(f'<polyline points="{d}" fill="none" '
                     f'stroke="var({color})" stroke-width="2" '
                     f'stroke-linejoin="round"/>')
        for x, y in ps:
            parts.append(
                f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="8" '
                f'fill="transparent" stroke="none">'
                f'<title>{html_mod.escape(label)} @ {fmt_x(x)}: '
                f'{fmt(y)}</title></circle>')
    parts.append("</svg>")
    return "".join(parts)


def fmt_x(x) -> str:
    return f"{int(x):,}"


def render_html(summary: dict, source: str) -> str:
    totals = summary["totals"]
    obs = summary["obs_epochs"]
    epochs = summary["epochs"]
    windows = summary["step_windows"]
    alerts = summary["alerts"]
    e = html_mod.escape

    tiles = []

    def tile(value, key):
        tiles.append(f'<div class="tile"><div class="v">{e(str(value))}'
                     f'</div><div class="k">{e(key)}</div></div>')

    thr = totals.get("tokens_per_sec", totals.get("examples_per_sec"))
    if thr is not None:
        tile(_fmt_rate(thr),
             "tokens/s" if "tokens_per_sec" in totals else "examples/s")
    if totals.get("mfu") is not None:
        tile(f"{totals['mfu']:.3f}", "MFU")
    if "stall_frac" in totals:
        tile(f"{100 * totals['stall_frac']:.1f}%", "input stall")
    if totals.get("peak_bytes_in_use") is not None:
        tile(f"{totals['peak_bytes_in_use'] / 2**30:.2f} GiB",
             "peak device mem")
    if totals.get("live_processes") is not None:
        tile(totals["live_processes"], "live processes")
    tile(totals.get("alerts", 0), "alerts")

    cards = []
    if obs:
        pts = [(r["epoch"],
                r.get("tokens_per_sec", r.get("examples_per_sec")))
               for r in obs]
        chart = _svg_line_chart([("--s1", "throughput", pts)],
                                fmt=_fmt_rate)
        cards.append('<div class="card"><h2>Throughput per epoch</h2>'
                     + chart + "</div>")
    if windows:
        p50 = [(w["step_lo"], w["step_time_p50_s"] * 1e3) for w in windows]
        p99 = [(w["step_lo"], w["step_time_p99_s"] * 1e3) for w in windows]
        chart = _svg_line_chart(
            [("--s1", "p50", p50), ("--s2", "p99", p99)],
            fmt=lambda v: f"{v:.1f}ms")
        cards.append(
            '<div class="card"><h2>Step time trend (per obs_step window)'
            '</h2><div class="legend">'
            '<span class="sw" style="background:var(--s1)"></span>p50'
            '&nbsp;&nbsp;'
            '<span class="sw" style="background:var(--s2)"></span>p99'
            "</div>" + chart + "</div>")

    if alerts:
        rows = "".join(
            f'<tr class="alert"><td>{e(str(a.get("reason", "?")))}</td>'
            f'<td>{a.get("step", "?")}</td>'
            f'<td>{e(str(a.get("severity", "warn")))}</td>'
            f'<td style="text-align:left">'
            f'{e(json.dumps({k: v for k, v in a.items() if k not in ("kind", "reason", "step", "severity")}))}'
            f"</td></tr>" for a in alerts)
        cards.append('<div class="card"><h2>Alerts</h2><table>'
                     "<tr><th>reason</th><th>step</th><th>severity</th>"
                     '<th style="text-align:left">detail</th></tr>'
                     + rows + "</table></div>")

    if epochs or obs:
        by_epoch = {r["epoch"]: dict(r) for r in epochs}
        for r in obs:
            by_epoch.setdefault(r["epoch"], {}).update(r)
        rows = []
        for ep in sorted(by_epoch):
            r = by_epoch[ep]
            t = r.get("tokens_per_sec", r.get("examples_per_sec"))
            p50 = r.get("step_time_p50_s")
            rows.append(
                f"<tr><td>{ep}</td>"
                f"<td>{r.get('seconds', r.get('train_seconds', 0)):.1f}</td>"
                f"<td>{r.get('train_loss', float('nan')):.4f}</td>"
                f"<td>{r.get('test_accuracy', float('nan')):.4f}</td>"
                f"<td>{'-' if t is None else _fmt_rate(t)}</td>"
                f"<td>{'-' if p50 is None else f'{p50 * 1e3:.1f}'}</td>"
                f"<td>{100 * r.get('stall_frac', 0.0):.1f}%</td></tr>")
        cards.append('<div class="card"><h2>Epochs</h2><table>'
                     "<tr><th>ep</th><th>secs</th><th>train loss</th>"
                     "<th>test acc</th><th>thruput</th><th>p50 ms</th>"
                     "<th>stall</th></tr>" + "".join(rows)
                     + "</table></div>")

    return ("<!doctype html><html><head><meta charset='utf-8'>"
            "<meta name='viewport' content='width=device-width,"
            "initial-scale=1'>"
            f"<title>tpunet obs — {e(source)}</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<h1>tpunet observability report</h1>"
            f'<p class="sub">{e(source)} — generated '
            f"{time.strftime('%Y-%m-%d %H:%M:%S')}</p>"
            f'<div class="tiles">{"".join(tiles)}</div>'
            + "".join(cards) + "</body></html>")


# ---------------------------------------------------------------------------
# fleet view (tpunet_torch.obs.agg)
# ---------------------------------------------------------------------------

_SERIES = ("--s1", "--s2", "--s3", "--s4", "--s5")


def _ms(v) -> str:
    return "-" if v is None else f"{v * 1e3:.1f}"


def _fleet_alerts(agg):
    """What the fleet alert panels show: the bridge's own fleet-scope
    alerts plus per-run pages ingested from the streams
    (thread_stalled, step_stall, ...) and each stream's last crash —
    deduplicated so a crash the bridge already paged is one row, not
    two — but keyed on the distinguishing detail too (thread name,
    report path), so two stalled threads of one stream stay two rows
    (the per-thread semantics tpunet_torch/obs/health.py promises)."""
    def key(a):
        return (a.get("reason"), a.get("stream"), a.get("thread"),
                a.get("report_path"))

    alerts = list(agg.bridge.alerts)
    seen = {key(a) for a in alerts}
    for a in agg.recent_alerts():
        if key(a) not in seen:
            seen.add(key(a))
            alerts.append(a)
    return alerts


def _regression_rows(agg):
    """Fleet regression panel rows: pairwise last-window compare of
    trainer streams sharing a config fingerprint
    (tpunet_torch/obs/history/compare.stream_regressions) — the cross-run
    view that makes an elastic rerun judgeable against its static
    baseline from the same dashboard."""
    from tpunet_torch.obs.history import stream_regressions
    return stream_regressions(agg.streams())


def render_fleet_terminal(rollup: dict, ages: dict, source: str,
                          alerts=(), regressions=()) -> str:
    """One text frame of the fleet rollup + per-stream table."""
    out = [f"tpunet fleet dashboard — {source} — "
           f"{time.strftime('%H:%M:%S')}"]
    head = [f"streams {rollup.get('streams', 0)}"]
    unit = rollup.get("throughput_unit")
    if unit:
        head.append(f"{_fmt_rate(rollup[f'{unit}_per_sec'])} "
                    f"{'tok/s' if unit == 'tokens' else 'ex/s'} total")
    if rollup.get("step_time_p50_s") is not None:
        head.append(f"fleet p50 {_ms(rollup['step_time_p50_s'])}ms "
                    f"p99 {_ms(rollup.get('step_time_p99_s'))}ms "
                    f"(±{rollup.get('step_time_rank_err', 0):.3f} rank)")
    if rollup.get("straggler_factor") is not None:
        head.append(f"straggler x{rollup['straggler_factor']:.2f}")
    if rollup.get("serve_queue_depth") is not None:
        head.append(f"queue {rollup['serve_queue_depth']}")
    if rollup.get("crashes_total"):
        head.append(f"CRASHES {rollup['crashes_total']}")
    if rollup.get("elastic_events_total"):
        last = rollup.get("elastic_last_event", "")
        gen = rollup.get("elastic_generation")
        head.append(f"ELASTIC {rollup['elastic_events_total']}"
                    + (f" (last {last}"
                       + (f", gen {gen}" if gen is not None else "")
                       + ")" if last else ""))
    if rollup.get("routers"):
        last = rollup.get("router_last_event", "")
        head.append(
            f"ROUTER {rollup.get('router_replicas_healthy', 0)}"
            f"/{rollup.get('router_replicas', 0)} healthy"
            + (f" (last {last})" if last else ""))
    out.append("  ".join(head))
    out.append("")

    if alerts:
        out.append(f"FLEET ALERTS ({len(alerts)}):")
        for a in alerts[-8:]:
            extra = ""
            if a.get("reason") == "crash":
                extra = f" {a.get('cause', '')}"
            elif a.get("reason") == "thread_stalled":
                extra = (f" {a.get('thread', '')} "
                         f"{a.get('age_s', '')}s")
            out.append(f"  [{a.get('scope', '?'):>6}] "
                       f"{a.get('reason', '?')} "
                       f"{a.get('stream', '')}{extra}")
        out.append("")

    rows = rollup.get("per_stream", [])
    if rows:
        out.append(f"{'stream':<24} {'ep':>4} {'step':>8} {'p50ms':>8} "
                   f"{'thruput':>9} {'mfu':>6} {'age s':>6}")
        for r in rows:
            t = r.get("tokens_per_sec", r.get("examples_per_sec"))
            mfu = r.get("mfu")
            age = ages.get(r["stream"])
            out.append(
                f"{r['stream']:<24.24} {r.get('epoch', '-'):>4} "
                f"{r.get('step', '-'):>8} "
                f"{_ms(r.get('step_time_p50_s')):>8} "
                f"{_fmt_rate(t):>9} "
                f"{'-' if mfu is None else f'{mfu:6.3f}'} "
                f"{'-' if age is None else f'{age:6.1f}'}")
        out.append("")

    if regressions:
        flagged = [r for r in regressions
                   if r["verdict"] != "within_error"]
        out.append(f"REGRESSION COMPARE ({len(regressions)} pair(s), "
                   f"{len(flagged)} outside error bars):")
        for r in regressions[-6:]:
            out.append(
                f"  [{r['verdict']:>12}] {r['stream']:<24.24} vs "
                f"{r['base']:<24.24} p50 {_ms(r['a'])} -> "
                f"{_ms(r['b'])}ms "
                f"({100 * (r.get('delta_frac') or 0):+.1f}%)")
        out.append("")

    if rollup.get("routers"):
        out.append(
            f"router: {rollup.get('router_replicas_healthy', 0)}"
            f"/{rollup.get('router_replicas', 0)} replicas healthy  "
            f"queue {rollup.get('router_fleet_queue_depth', 0)}  "
            f"evictions {rollup.get('router_evictions_total', 0)}  "
            f"respawns {rollup.get('router_respawns_total', 0)}  "
            f"scale +{rollup.get('router_scale_ups_total', 0)}"
            f"/-{rollup.get('router_scale_downs_total', 0)}"
            + (f"  last {rollup['router_last_event']}"
               if rollup.get("router_last_event") else ""))
    if rollup.get("serve_replicas"):
        out.append(
            f"serve: {rollup['serve_replicas']} replicas  "
            f"queue {rollup.get('serve_queue_depth', 0)}  "
            f"slots {rollup.get('serve_active_slots', 0)}"
            f"/{rollup.get('serve_slots', 0)}  "
            f"reject {100 * rollup.get('serve_reject_rate', 0.0):.2f}%")
        if rollup.get("serve_ttft_p50_s") is not None:
            out.append(
                f"  TTFT p50 {_ms(rollup['serve_ttft_p50_s'])}ms "
                f"p99 {_ms(rollup.get('serve_ttft_p99_s'))}ms   "
                f"e2e p50 {_ms(rollup.get('serve_e2e_p50_s'))}ms "
                f"p99 {_ms(rollup.get('serve_e2e_p99_s'))}ms")
    if rollup.get("slo_table"):
        worst = rollup.get("fleet_slo_worst_budget_remaining")
        line = (f"SLO: {rollup.get('fleet_slo_firing', 0)} firing  "
                f"pages {rollup.get('fleet_slo_pages_total', 0)}  "
                f"tickets {rollup.get('fleet_slo_tickets_total', 0)}")
        if worst is not None:
            line += (f"  worst budget {100 * worst:.1f}% "
                     f"({rollup.get('fleet_slo_worst_slo', '?')})")
        out.append(line)
        spark = sparkline(rollup.get("slo_burn_spark", []))
        if spark:
            out.append(f"  page-burn trend  {spark}")
        for r in rollup["slo_table"][:8]:
            b = r.get("budget_remaining")
            burn = r.get("page_burn_long")
            flag = ("FIRING" if r.get("page_firing")
                    else "ticket" if r.get("ticket_firing") else "")
            out.append(
                f"  {r.get('name', '?'):<14.14} "
                f"obj {r.get('objective', 0):<7} "
                f"budget {'-' if b is None else f'{100 * b:6.1f}%'}  "
                f"burn {'-' if burn is None else f'{burn:7.2f}x'}  "
                f"{flag}")
        if rollup.get("fleet_slo_probe_requests_total"):
            out.append(
                f"  probes {rollup['fleet_slo_probe_requests_total']}"
                f" ({rollup.get('fleet_slo_probe_failures_total', 0)}"
                f" failed, "
                f"{rollup.get('fleet_slo_probe_mismatches_total', 0)}"
                f" golden mismatches)"
                + (f"  last failed trace "
                   f"{rollup['fleet_slo_last_failed_trace']}"
                   if rollup.get("fleet_slo_last_failed_trace")
                   else ""))
        out.append("")
    if rollup.get("trace_records_total"):
        line = (f"trace: {rollup['trace_records_total']} sampled")
        if rollup.get("trace_queue_p99_s") is not None:
            line += (
                f"  p99 split queue {_ms(rollup['trace_queue_p99_s'])}"
                f" / prefill {_ms(rollup.get('trace_prefill_p99_s'))}"
                f" / first-decode "
                f"{_ms(rollup.get('trace_first_decode_p99_s'))} ms")
        out.append(line)
        for t in rollup.get("trace_slow", [])[:5]:
            out.append("  " + _trace_exemplar_row(t))
    if len(out) <= 3:
        out.append("waiting for records...")
    return "\n".join(out)


def _trace_exemplar_row(t: dict, bar_width: int = 24) -> str:
    """One slow-trace exemplar line: trace_id (the obs_timeline
    lookup key), e2e, and a phase bar splitting it into
    q(ueue)/p(refill)/d(ecode) shares."""
    e2e = t.get("e2e_s") or 0.0
    q = t.get("queue_s") or 0.0
    p = t.get("prefill_s") or 0.0
    d = max(0.0, e2e - q - p)
    bar = ""
    if e2e > 0:
        nq = int(round(bar_width * q / e2e))
        np_ = int(round(bar_width * p / e2e))
        nd = max(0, bar_width - nq - np_) if d > 0 else 0
        bar = "[" + "q" * nq + "p" * np_ + "d" * nd + "]"
    extra = ""
    if t.get("failover_count"):
        extra += f"  failovers {t['failover_count']}"
    if t.get("preemptions"):
        extra += f"  preempts {t['preemptions']}"
    return (f"{t.get('trace_id', '?'):<16.16} "
            f"e2e {_ms(e2e):>7}ms  {bar:<{bar_width + 2}} "
            f"q {_ms(q)} p {_ms(p)} ms  "
            f"{t.get('finish_reason', '')}{extra}")


def render_fleet_html(rollup: dict, streams, source: str,
                      alerts=(), regressions=()) -> str:
    """Static fleet report: rollup tiles, per-stream step-time chart,
    regression-compare panel, per-stream table, serve SLO panel,
    fleet alert table."""
    e = html_mod.escape
    tiles = []

    def tile(value, key):
        tiles.append(f'<div class="tile"><div class="v">{e(str(value))}'
                     f'</div><div class="k">{e(key)}</div></div>')

    tile(rollup.get("streams", 0), "streams")
    unit = rollup.get("throughput_unit")
    if unit:
        tile(_fmt_rate(rollup[f"{unit}_per_sec"]),
             "tokens/s total" if unit == "tokens" else "examples/s total")
    if rollup.get("step_time_p50_s") is not None:
        tile(f"{_ms(rollup['step_time_p50_s'])} ms", "fleet step p50")
        tile(f"{_ms(rollup.get('step_time_p99_s'))} ms",
             f"fleet step p99 (±{rollup.get('step_time_rank_err', 0):.3f})")
    if rollup.get("straggler_factor") is not None:
        tile(f"x{rollup['straggler_factor']:.2f}", "straggler factor")
    if rollup.get("step_lag") is not None:
        tile(rollup["step_lag"], "step lag")
    tile(rollup.get("alerts_total", 0) + len(alerts), "alerts")
    if rollup.get("crashes_total"):
        tile(rollup["crashes_total"], "crashes")
    if rollup.get("elastic_events_total"):
        last = rollup.get("elastic_last_event", "")
        tile(rollup["elastic_events_total"],
             f"elastic events{f' (last {last})' if last else ''}")
    if rollup.get("routers"):
        last = rollup.get("router_last_event", "")
        tile(f"{rollup.get('router_replicas_healthy', 0)}"
             f"/{rollup.get('router_replicas', 0)}",
             f"router replicas{f' (last {last})' if last else ''}")
        if rollup.get("router_evictions_total") is not None:
            tile(f"{rollup.get('router_evictions_total', 0)}"
                 f"/{rollup.get('router_respawns_total', 0)}",
                 "router evictions/respawns")

    cards = []
    # Per-stream step-time trend: one line per stream, shared y scale.
    series = []
    legend = []
    for i, s in enumerate(streams):
        pts = [(ep, p * 1e3)
               for ep, p in list(getattr(s, "epoch_p50s", []))]
        if not pts:
            continue
        color = _SERIES[i % len(_SERIES)]
        series.append((color, s.key, pts))
        legend.append(f'<span class="sw" style="background:var({color})">'
                      f"</span>{e(s.key)}")
    if series:
        chart = _svg_line_chart(series, fmt=lambda v: f"{v:.1f}ms")
        cards.append('<div class="card"><h2>Step time p50 per epoch, '
                     'per stream</h2><div class="legend">'
                     + "&nbsp;&nbsp;".join(legend) + "</div>"
                     + chart + "</div>")

    if regressions:
        body = []
        for r in regressions:
            frac = r.get("delta_frac")
            body.append(
                f"<tr><td>{e(str(r['stream']))}</td>"
                f"<td>{e(str(r['base']))}</td>"
                f"<td>{e(str(r.get('fingerprint', '')))}</td>"
                f"<td>{_ms(r['a'])}</td><td>{_ms(r['b'])}</td>"
                f"<td>{'-' if frac is None else f'{100 * frac:+.1f}%'}"
                f"</td><td>{e(r['verdict'])}</td></tr>")
        cards.append(
            '<div class="card"><h2>Regression compare (same config '
            "fingerprint, step-time p50 vs DKW error bars)</h2>"
            "<table><tr><th>stream</th><th>baseline</th>"
            "<th>fingerprint</th><th>base p50 ms</th><th>p50 ms</th>"
            "<th>delta</th><th>verdict</th></tr>"
            + "".join(body) + "</table></div>")

    rows = rollup.get("per_stream", [])
    if rows:
        body = []
        for r in rows:
            t = r.get("tokens_per_sec", r.get("examples_per_sec"))
            mfu = r.get("mfu")
            body.append(
                f"<tr><td>{e(str(r['stream']))}</td>"
                f"<td>{e(str(r.get('host', '-')))}</td>"
                f"<td>{r.get('epoch', '-')}</td>"
                f"<td>{r.get('step', '-')}</td>"
                f"<td>{_ms(r.get('step_time_p50_s'))}</td>"
                f"<td>{'-' if t is None else _fmt_rate(t)}</td>"
                f"<td>{'-' if mfu is None else f'{mfu:.3f}'}</td>"
                f"<td>{r.get('alerts', 0)}</td></tr>")
        cards.append('<div class="card"><h2>Streams</h2><table>'
                     "<tr><th>stream</th><th>host</th><th>ep</th>"
                     "<th>step</th><th>p50 ms</th><th>thruput</th>"
                     "<th>mfu</th><th>alerts</th></tr>"
                     + "".join(body) + "</table></div>")

    if rollup.get("serve_replicas"):
        sv_tiles = []

        def sv_tile(value, key):
            sv_tiles.append(
                f'<div class="tile"><div class="v">{e(str(value))}'
                f'</div><div class="k">{e(key)}</div></div>')

        sv_tile(rollup["serve_replicas"], "replicas")
        sv_tile(rollup.get("serve_queue_depth", 0), "total queue depth")
        sv_tile(f"{rollup.get('serve_active_slots', 0)}"
                f"/{rollup.get('serve_slots', 0)}", "active slots")
        if rollup.get("serve_ttft_p50_s") is not None:
            sv_tile(f"{_ms(rollup['serve_ttft_p50_s'])} ms", "fleet TTFT p50")
            sv_tile(f"{_ms(rollup.get('serve_ttft_p99_s'))} ms",
                    f"fleet TTFT p99 "
                    f"(±{rollup.get('serve_ttft_rank_err', 0):.3f})")
        if rollup.get("serve_e2e_p99_s") is not None:
            sv_tile(f"{_ms(rollup['serve_e2e_p99_s'])} ms", "fleet e2e p99")
        sv_tile(f"{100 * rollup.get('serve_reject_rate', 0.0):.2f}%",
                "reject rate")
        body = []
        for r in rows:
            if r.get("serve_requests_total") is None:
                continue
            body.append(
                f"<tr><td>{e(str(r['stream']))}</td>"
                f"<td>{r.get('serve_queue_depth', 0)}</td>"
                f"<td>{r.get('serve_active_slots', 0)}"
                f"/{r.get('serve_slots', 0)}</td>"
                f"<td>{r.get('serve_requests_total', 0)}</td>"
                f"<td>{100 * r.get('serve_reject_rate', 0.0):.2f}%</td>"
                f"<td>{_ms(r.get('serve_ttft_p50_s'))}</td>"
                f"<td>{_ms(r.get('serve_e2e_p99_s'))}</td></tr>")
        table = ""
        if body:
            table = ("<table><tr><th>replica</th><th>queue</th>"
                     "<th>slots</th><th>requests</th><th>reject</th>"
                     "<th>ttft p50 ms</th><th>e2e p99 ms</th></tr>"
                     + "".join(body) + "</table>")
        cards.append('<div class="card"><h2>Serve SLO (fleet)</h2>'
                     f'<div class="tiles">{"".join(sv_tiles)}</div>'
                     + table + "</div>")

    if rollup.get("slo_table"):
        slo_tiles = []

        def slo_tile(value, key):
            slo_tiles.append(
                f'<div class="tile"><div class="v">{e(str(value))}'
                f'</div><div class="k">{e(key)}</div></div>')

        worst = rollup.get("fleet_slo_worst_budget_remaining")
        if worst is not None:
            slo_tile(f"{100 * worst:.1f}%",
                     f"worst budget "
                     f"({rollup.get('fleet_slo_worst_slo', '?')})")
        if rollup.get("fleet_slo_max_page_burn") is not None:
            slo_tile(f"x{rollup['fleet_slo_max_page_burn']:.2f}",
                     "max page burn")
        slo_tile(rollup.get("fleet_slo_firing", 0), "SLOs firing")
        slo_tile(f"{rollup.get('fleet_slo_pages_total', 0)}"
                 f"/{rollup.get('fleet_slo_tickets_total', 0)}",
                 "pages/tickets")
        if rollup.get("fleet_slo_probe_requests_total"):
            slo_tile(f"{rollup.get('fleet_slo_probe_failures_total', 0)}"
                     f"+{rollup.get('fleet_slo_probe_mismatches_total', 0)}"
                     f"/{rollup['fleet_slo_probe_requests_total']}",
                     "probe fails+mismatches/total")
        body = []
        for r in rollup["slo_table"]:
            b = r.get("budget_remaining")
            burn = r.get("page_burn_long")
            firing = ("page" if r.get("page_firing")
                      else "ticket" if r.get("ticket_firing") else "")
            cls = ' class="alert"' if firing else ""
            body.append(
                f"<tr{cls}><td>{e(str(r.get('stream', '')))}</td>"
                f"<td>{e(str(r.get('name', '?')))}</td>"
                f"<td>{e(str(r.get('sli', '')))}</td>"
                f"<td>{r.get('objective', '-')}</td>"
                f"<td>{'-' if b is None else f'{100 * b:.1f}%'}</td>"
                f"<td>{'-' if burn is None else f'x{burn:.2f}'}</td>"
                f"<td>{r.get('pages_total', 0)}"
                f"/{r.get('tickets_total', 0)}</td>"
                f"<td>{e(firing)}</td></tr>")
        extras = ""
        spark = sparkline(rollup.get("slo_burn_spark", []), width=48)
        if spark:
            extras += (f'<p class="legend">page-burn trend '
                       f"(worst stream): <code>{e(spark)}</code></p>")
        if rollup.get("fleet_slo_last_failed_trace"):
            tid = rollup["fleet_slo_last_failed_trace"]
            extras += (f'<p class="legend">last failed probe trace: '
                       f"<code>{e(str(tid))}</code> (join with "
                       "scripts/obs_timeline.py)</p>")
        cards.append(
            '<div class="card"><h2>Error budget (SLOs, '
            "tpunet/obs/slo.py)</h2>"
            f'<div class="tiles">{"".join(slo_tiles)}</div>'
            + extras
            + "<table><tr><th>stream</th><th>slo</th><th>sli</th>"
              "<th>objective</th><th>budget left</th>"
              "<th>page burn</th><th>pages/tickets</th>"
              "<th>firing</th></tr>"
            + "".join(body) + "</table></div>")

    if rollup.get("trace_slow"):
        tr_tiles = []

        def tr_tile(value, key):
            tr_tiles.append(
                f'<div class="tile"><div class="v">{e(str(value))}'
                f'</div><div class="k">{e(key)}</div></div>')

        tr_tile(rollup.get("trace_records_total", 0), "traces sampled")
        if rollup.get("trace_queue_p99_s") is not None:
            tr_tile(f"{_ms(rollup['trace_queue_p99_s'])} ms",
                    "queue p99")
            tr_tile(f"{_ms(rollup.get('trace_prefill_p99_s'))} ms",
                    "prefill p99")
            tr_tile(f"{_ms(rollup.get('trace_first_decode_p99_s'))} ms",
                    "first-decode p99")
        body = []
        for t in rollup["trace_slow"]:
            e2e = t.get("e2e_s") or 0.0
            q = t.get("queue_s") or 0.0
            p = t.get("prefill_s") or 0.0
            d = max(0.0, e2e - q - p)
            bar = ""
            if e2e > 0:
                segs = (("#e0a030", q), ("#4090e0", p), ("#40c070", d))
                bar = "".join(
                    f'<span style="display:inline-block;height:10px;'
                    f"background:{c};width:{max(1, round(120 * v / e2e))}px"
                    '"></span>' for c, v in segs if v > 0)
            body.append(
                f"<tr><td><code>{e(str(t.get('trace_id', '?')))}</code></td>"
                f"<td>{_ms(e2e)}</td>"
                f'<td style="text-align:left">{bar}</td>'
                f"<td>{_ms(q)}</td><td>{_ms(p)}</td>"
                f"<td>{e(str(t.get('finish_reason', '')))}</td>"
                f"<td>{t.get('failover_count', 0)}</td></tr>")
        cards.append(
            '<div class="card"><h2>Slow-request exemplars '
            "(top traces by e2e — join the full span tree with "
            "scripts/obs_timeline.py)</h2>"
            f'<div class="tiles">{"".join(tr_tiles)}</div>'
            "<table><tr><th>trace_id</th><th>e2e ms</th>"
            '<th style="text-align:left">queue / prefill / decode</th>'
            "<th>queue ms</th><th>prefill ms</th><th>finish</th>"
            "<th>failovers</th></tr>"
            + "".join(body) + "</table></div>")

    if alerts:
        body = "".join(
            f'<tr class="alert"><td>{e(str(a.get("reason", "?")))}</td>'
            f'<td>{e(str(a.get("scope", "?")))}</td>'
            f'<td>{e(str(a.get("stream", "")))}</td>'
            f'<td style="text-align:left">'
            f'{e(json.dumps({k: v for k, v in a.items() if k not in ("kind", "reason", "scope", "stream", "severity", "step", "run_id", "process_index", "host")}))}'
            f"</td></tr>" for a in alerts)
        cards.append('<div class="card"><h2>Fleet alerts</h2><table>'
                     "<tr><th>reason</th><th>scope</th><th>stream</th>"
                     '<th style="text-align:left">detail</th></tr>'
                     + body + "</table></div>")

    return ("<!doctype html><html><head><meta charset='utf-8'>"
            "<meta name='viewport' content='width=device-width,"
            "initial-scale=1'>"
            f"<title>tpunet fleet — {e(source)}</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<h1>tpunet fleet observability report</h1>"
            f'<p class="sub">{e(source)} — generated '
            f"{time.strftime('%Y-%m-%d %H:%M:%S')}</p>"
            f'<div class="tiles">{"".join(tiles)}</div>'
            + "".join(cards) + "</body></html>")


# ---------------------------------------------------------------------------
# record sources: file tail / HTTP listener
# ---------------------------------------------------------------------------


class RecordBuffer:
    """Thread-safe accumulator both sources feed.

    Bounded: a multi-day run with --obs-step-every 1 would otherwise
    grow (and re-summarize) an unbounded list. Epoch-grained records
    and alerts are small and all kept; high-volume ``obs_step``
    records are compacted to the most recent ``max_steps`` — exactly
    what the trend view renders anyway."""

    def __init__(self, max_steps: int = 20_000):
        self._records: list = []
        self._max_steps = max_steps
        self._lock = threading.Lock()

    def feed(self, records) -> None:
        with self._lock:
            self._records.extend(records)
            n_steps = sum(1 for r in self._records
                          if r.get("kind") == "obs_step")
            if n_steps > 2 * self._max_steps:
                drop = n_steps - self._max_steps
                kept = []
                for r in self._records:
                    if drop > 0 and r.get("kind") == "obs_step":
                        drop -= 1
                        continue
                    kept.append(r)
                self._records = kept

    def clear(self) -> None:
        """Forget everything — the tailed file was truncated by a
        fresh run; merging two runs' records would corrupt every
        aggregate."""
        with self._lock:
            self._records = []

    def snapshot(self) -> list:
        with self._lock:
            return list(self._records)


def serve_http(port: int, buf: RecordBuffer, source_name: str,
               agg=None):
    """Line-JSON ingest endpoint matching HttpLineTransport: POST
    bodies are newline-delimited records; GET returns the current
    text render. With ``agg`` (fleet mode) each record is also routed
    into the aggregator by its identity stamp — N runs posting
    concurrently become N streams (handler threads ingest
    concurrently; the aggregator is thread-safe)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from tpunet_torch.obs.summary import summarize

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            records = []
            for line in body.splitlines():
                if not line.strip():
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    pass    # one bad line must not poison the stream
            if agg is not None:
                # Fleet mode renders from the aggregator only; also
                # filling the buffer would grow an unrendered list of
                # non-step records without bound.
                agg.ingest_many(
                    records, source=self.client_address[0])
            else:
                buf.feed(records)
            self.send_response(204)
            self.end_headers()

        def do_GET(self):
            if agg is not None:
                text = render_fleet_terminal(
                    agg.rollup(), agg.heartbeat_ages(), source_name,
                    alerts=_fleet_alerts(agg),
                    regressions=_regression_rows(agg))
            else:
                text = render_terminal(summarize(buf.snapshot()),
                                       source_name)
            data = (text + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="*",
                    help="metrics.jsonl (or a directory containing "
                         "one); several paths = fleet mode; omit with "
                         "--listen")
    ap.add_argument("--listen", type=int, metavar="PORT",
                    help="receive line-JSON POSTs (train.py "
                         "--obs-http http://HOST:PORT/) instead of "
                         "tailing a file")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (no follow loop)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh/poll period in seconds (default 2)")
    ap.add_argument("--html", metavar="OUT",
                    help="write a static self-contained HTML report "
                         "(re-written every refresh in follow mode)")
    ap.add_argument("--last", type=int, default=10,
                    help="epochs shown in the terminal table")
    ap.add_argument("--fleet", action="store_true",
                    help="aggregate --listen streams by run identity "
                         "(automatic when several paths are given)")
    ap.add_argument("--straggler-factor", type=float, default=2.0,
                    help="fleet straggler alert: slowest stream's step "
                         "time above FACTOR x the median of the rest")
    ap.add_argument("--stale-after", type=float, default=0.0,
                    metavar="SECONDS",
                    help="fleet stream_stale alert when a live stream "
                         "stops posting for this long (0 = off)")
    ap.add_argument("--mem-growth", type=float, default=0.0,
                    metavar="BYTES_PER_EPOCH",
                    help="fleet mem_growth alert when any stream's "
                         "peak device bytes grow faster than this per "
                         "epoch (0 = off)")
    ap.add_argument("--rule", action="append", default=[],
                    metavar="RULE",
                    help="GaugePredicate rule evaluated fleet-wide AND "
                         "per stream (e.g. 'serve_queue_depth > 10'); "
                         "repeatable")
    ap.add_argument("--webhook", metavar="URL",
                    help="fleet mode: POST one templated JSON payload "
                         "per fired alert (straggler/crash/stale/"
                         "mem_growth/--rule) to this URL — wire "
                         "format in docs/metrics_schema.md")
    args = ap.parse_args(argv)

    if bool(args.path) == (args.listen is not None):
        ap.error("give metrics.jsonl path(s) OR --listen PORT")

    from tpunet_torch.obs.summary import summarize
    from tpunet_torch.utils.logging import MetricsLogger

    paths = []
    for p in args.path:
        if os.path.isdir(p):
            p = os.path.join(p, "metrics.jsonl")
        paths.append(p)
    fleet = args.fleet or len(paths) > 1

    agg = None
    webhook = None
    if fleet:
        from tpunet_torch.obs.agg import Aggregator
        agg = Aggregator(straggler_factor=args.straggler_factor,
                         stream_stale_s=args.stale_after,
                         mem_growth_bytes_per_epoch=args.mem_growth,
                         rules=tuple(args.rule))
        if args.webhook:
            # The bridge emits its obs_alert records through the
            # aggregator's registry; attaching the webhook sink there
            # turns every fired fleet alert into one POST.
            from tpunet_torch.obs.export import AlertWebhook
            webhook = AlertWebhook(args.webhook, registry=agg.registry)
            agg.registry.add_sink(webhook)
    elif args.webhook:
        ap.error("--webhook needs fleet mode (several paths or "
                 "--fleet): only the fleet aggregator emits alerts "
                 "from the dashboard process")

    buf = RecordBuffer()
    offsets = {p: 0 for p in paths}
    if args.listen is not None:
        source = f"http://:{args.listen}"
        serve_http(args.listen, buf, source, agg=agg)
    else:
        source = paths[0] if len(paths) == 1 else f"{len(paths)} streams"
        if args.once:
            missing = [p for p in paths if not os.path.isfile(p)]
            if missing:
                print(f"no metrics.jsonl at {', '.join(missing)}",
                      file=sys.stderr)
                return 1

    def refresh():
        for p in paths:
            records, offsets[p], reset = MetricsLogger.tail_records(
                p, offsets[p])
            if reset:
                # Fresh run truncated the file underneath us: drop the
                # old run's records (already re-read from the start),
                # or every aggregate would straddle two runs.
                if agg is not None:
                    agg.drop_source(p)
                buf.clear()
            if agg is not None:
                # Follow-mode tailing IS live: stamp arrival so
                # --stale-after can page a silent replica. Only a
                # --once replay skips the clock (so replayed and
                # concurrently-ingested rollups compare equal).
                # Identity-less old files fall back to
                # one-file-one-stream via the source tag.
                agg.ingest_many(records, source=p,
                                stamp_time=not args.once)
            else:
                buf.feed(records)
        if agg is not None:
            rollup = agg.rollup()
            agg.bridge.check(rollup, agg.streams(),
                             now=time.monotonic())
            return rollup
        return summarize(buf.snapshot())

    def render_text(view):
        if agg is not None:
            return render_fleet_terminal(view, agg.heartbeat_ages(),
                                         source,
                                         alerts=_fleet_alerts(agg),
                                         regressions=_regression_rows(agg))
        return render_terminal(view, source, last=args.last)

    def render_page(view):
        if agg is not None:
            return render_fleet_html(view, agg.streams(), source,
                                     alerts=_fleet_alerts(agg),
                                     regressions=_regression_rows(agg))
        return render_html(view, source)

    def close_webhook() -> None:
        # Flush queued/backing-off pages before exit: without the
        # close, a page mid-retry dies with the daemon thread —
        # neither delivered, dead-lettered, NOR counted dropped.
        if webhook is None:
            return
        webhook.close()
        st = webhook.stats()
        if st["send_errors"] or st["dropped"]:
            print(f"webhook delivery incomplete: {st}",
                  file=sys.stderr)

    view = refresh()
    if args.html:
        with open(args.html, "w") as f:
            f.write(render_page(view))
    if args.once:
        print(render_text(view))
        close_webhook()
        return 0

    try:
        while True:
            # Full-frame redraw: clear + home, like top(1).
            sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(render_text(view) + "\n")
            sys.stdout.flush()
            if args.html:
                tmp = args.html + ".tmp"
                with open(tmp, "w") as f:
                    f.write(render_page(view))
                os.replace(tmp, args.html)
            time.sleep(args.interval)
            view = refresh()
    except KeyboardInterrupt:
        return 0
    finally:
        close_webhook()


if __name__ == "__main__":
    sys.exit(main())
