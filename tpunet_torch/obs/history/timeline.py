"""Unified Perfetto / chrome-trace timeline from flight-recorder rings.

Every run already records its host story into the crash-durable event
ring (``tpunet_torch/obs/flightrec/``): span begin/end pairs
(``_RecordedSpan`` — step, data-wait, eval, checkpoint, serve prefill/
decode phases), host-thread busy/idle transitions (``ThreadHandle``
state flips), serve request lifecycles (submit -> prefill ->
first_token -> finish), alerts, and epoch marks — each slot stamped
with ``time.time()`` and the recording thread id. This module turns
one or more run dirs' rings into a single chrome-trace JSON loadable
in ui.perfetto.dev (or chrome://tracing): the first view that shows
host threads, device phases, and serve requests on one clock.

Event mapping (chrome trace format):

- ``span``/``span_end``  -> ``B``/``E`` duration pairs on the
  recording thread's track (unmatched opens are closed at the ring's
  last timestamp so the output is always phase-paired);
- ``thread`` beats       -> one synthetic track per registered thread
  name, busy periods as complete ``X`` events;
- ``req`` lifecycle      -> one synthetic track per request:
  ``queue``/``prefill``/``decode`` ``X`` phases, finish reason in args;
- everything else        -> thread-scoped instant events (``i``).

Timestamps are microseconds relative to the earliest event across all
rings (wall clock — the rings of one host share it), emitted in
non-decreasing order. Multi-process runs contribute one trace process
per ring (``events.ring``, ``events.p1.ring``, ...); thread names come
from the run's persisted host-thread registry snapshot when present.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from tpunet_torch.obs.flightrec import ring as _ring
from tpunet_torch.obs.tracing import parse_crumb

#: Instant-event kinds worth a mark on the timeline (everything not
#: otherwise structured lands here too — unknown kinds degrade to
#: instants, never to silence).
_RING_GLOB = re.compile(r"^events(\.p(\d+))?\.ring$")


def discover_rings(run_dir: str) -> List[Tuple[int, str]]:
    """(process_index, ring path) for every ring under a run dir —
    accepts the run dir itself, its ``flightrec/`` subdir, or a direct
    ring file path."""
    if os.path.isfile(run_dir):
        return [(0, run_dir)]
    for base in (os.path.join(run_dir, "flightrec"), run_dir):
        if not os.path.isdir(base):
            continue
        out = []
        for name in sorted(os.listdir(base)):
            m = _RING_GLOB.match(name)
            if m:
                out.append((int(m.group(2) or 0),
                            os.path.join(base, name)))
        if out:
            return out
    return []


def _read_meta(ring_path: str, process_index: int) -> dict:
    base = os.path.dirname(ring_path)
    name = ("meta.json" if process_index == 0
            else f"meta.p{process_index}.json")
    try:
        with open(os.path.join(base, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _read_thread_names(ring_path: str, process_index: int
                       ) -> Dict[int, str]:
    """ident -> registered name from the persisted registry snapshot
    (refreshed at epoch boundaries), when the run left one."""
    base = os.path.dirname(ring_path)
    name = ("threads.json" if process_index == 0
            else f"threads.p{process_index}.json")
    try:
        with open(os.path.join(base, name)) as f:
            rows = json.load(f)
    except (OSError, ValueError):
        return {}
    out: Dict[int, str] = {}
    for row in rows or []:
        if isinstance(row, dict) and row.get("ident") is not None:
            out[int(row["ident"]) & 0xFFFFFFFFFFFFFFFF] = str(
                row.get("name", ""))
    return out


class _ProcessTrack:
    """Trace events for one ring (= one process incarnation)."""

    # Synthetic tid ranges: real threads are remapped to small ids,
    # thread-beat tracks and request tracks live above them so the
    # groups sort together in the Perfetto UI.
    THREAD_TRACK_BASE = 1000
    REQ_TRACK_BASE = 2000

    def __init__(self, pid: int, label: str,
                 thread_names: Dict[int, str],
                 trace_join: "Optional[_TraceJoin]" = None):
        self.pid = pid
        self.label = label
        self.events: List[dict] = []
        self._tid_map: Dict[int, int] = {}
        self._tid_names = thread_names
        self._span_stack: Dict[int, List[Tuple[str, float]]] = {}
        self._busy: Dict[str, float] = {}      # thread name -> busy ts
        self._beat_tids: Dict[str, int] = {}
        self._reqs: Dict[str, dict] = {}
        self._trace_join = trace_join
        self._last_ts = 0.0

    # -- track bookkeeping ----------------------------------------------

    def _tid(self, raw_tid: int) -> int:
        if raw_tid not in self._tid_map:
            self._tid_map[raw_tid] = len(self._tid_map) + 1
        return self._tid_map[raw_tid]

    def _beat_tid(self, name: str) -> int:
        if name not in self._beat_tids:
            self._beat_tids[name] = (self.THREAD_TRACK_BASE
                                     + len(self._beat_tids))
        return self._beat_tids[name]

    def _emit(self, **ev) -> None:
        ev["pid"] = self.pid
        self.events.append(ev)

    # -- per-kind handling ----------------------------------------------

    def feed(self, event: dict, ts: float) -> None:
        self._last_ts = max(self._last_ts, ts)
        kind, msg = event["kind"], event["msg"]
        tid = self._tid(event["tid"])
        if kind == "span":
            self._span_stack.setdefault(tid, []).append((msg, ts))
            self._emit(name=msg, ph="B", ts=ts, tid=tid)
        elif kind == "span_end":
            stack = self._span_stack.get(tid) or []
            if stack:
                stack.pop()
                self._emit(name=msg, ph="E", ts=ts, tid=tid)
            # span_end without an open span (ring wrapped past the
            # begin): dropped — an unpaired E breaks B/E pairing.
        elif kind == "thread":
            state, _, name = msg.partition(" ")
            name = name or "?"
            started = self._busy.pop(name, None)
            if started is not None:
                self._emit(name="busy", ph="X", ts=started,
                           dur=max(0.0, ts - started),
                           tid=self._beat_tid(name))
            if state == "busy":
                self._busy[name] = ts
        elif kind == "req":
            parts = msg.split()
            if len(parts) < 2:
                return
            verb, rid = parts[0], parts[1]
            req = self._reqs.setdefault(rid, {})
            req.setdefault(verb, ts)
            if verb == "finish" and len(parts) > 2:
                req["reason"] = parts[2]
        elif kind == "trace":
            # Cross-process breadcrumb (tpunet_torch/obs/tracing.py): fed to
            # the shared join — rings share the wall clock, so one
            # trace's crumbs from a router ring and N replica rings
            # line up causally — plus a local instant so the crumb is
            # visible in this process's own track too.
            crumb = parse_crumb(msg)
            if crumb is None:
                return
            if self._trace_join is not None:
                self._trace_join.feed(crumb, ts, self.label)
            self._emit(name=f"trace {crumb['verb']}", ph="i", ts=ts,
                       tid=tid, s="t",
                       args={"trace_id": crumb["trace_id"],
                             "hop": crumb["hop"]})
        else:
            self._emit(name=f"{kind}: {msg}" if msg else kind,
                       ph="i", ts=ts, tid=tid, s="t")

    # -- finalization ----------------------------------------------------

    def _close_open(self) -> None:
        ts = self._last_ts
        for tid, stack in self._span_stack.items():
            while stack:
                name, _ = stack.pop()
                self._emit(name=name, ph="E", ts=ts, tid=tid)
        for name, started in sorted(self._busy.items()):
            self._emit(name="busy", ph="X", ts=started,
                       dur=max(0.0, ts - started),
                       tid=self._beat_tid(name))
        self._busy = {}

    def _req_events(self) -> None:
        """One synthetic track per request: queue (submit ->
        prefill), prefill (-> first token), decode (-> finish). A
        request killed while queued collapses to one queue phase."""
        for i, rid in enumerate(sorted(self._reqs, key=_req_sort_key)):
            req = self._reqs[rid]
            tid = self.REQ_TRACK_BASE + i
            self._emit(name="thread_name", ph="M", ts=0.0, tid=tid,
                       args={"name": f"req {rid}"})
            end = req.get("finish", self._last_ts)
            # A request whose only prefill was a resume-prefill (a
            # cross-replica failover resume landing on this replica)
            # still gets a prefill phase — the re-prefill IS the
            # request's compute cost here.
            pf = req.get("prefill", req.get("resume_prefill"))
            marks = [("queue", req.get("submit"),
                      pf if pf is not None else end),
                     ("prefill", pf, req.get("first_token", end)),
                     ("decode", req.get("first_token"), end)]
            for name, t0, t1 in marks:
                if t0 is None:
                    continue
                args = {"req": rid}
                if name == "decode" and req.get("reason"):
                    args["finish_reason"] = req["reason"]
                self._emit(name=name, ph="X", ts=t0,
                           dur=max(0.0, min(t1, end) - t0), tid=tid,
                           args=args)
            # Non-phase lifecycle verbs (client_gone on a mid-stream
            # disconnect, resume on a failover landing) become
            # instants on the request's own track — a decode ending
            # "cancelled" with this mark next to it reads as the
            # client's fault, not the engine's.
            for verb, t in sorted(req.items()):
                if verb in ("submit", "prefill", "resume_prefill",
                            "first_token", "finish", "reason"):
                    continue
                self._emit(name=verb, ph="i", ts=t, tid=tid, s="t",
                           args={"req": rid})

    def finalize(self) -> List[dict]:
        self._close_open()
        self._req_events()
        meta = [{"name": "process_name", "ph": "M", "ts": 0.0,
                 "pid": self.pid, "tid": 0,
                 "args": {"name": self.label}}]
        for raw, small in self._tid_map.items():
            name = self._tid_names.get(raw) or f"thread {raw & 0xFFFF}"
            meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                         "pid": self.pid, "tid": small,
                         "args": {"name": name}})
        for name, tid in self._beat_tids.items():
            meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                         "pid": self.pid, "tid": tid,
                         "args": {"name": f"host-thread {name}"}})
        return meta + self.events


def _req_sort_key(rid: str):
    return (0, int(rid)) if rid.isdigit() else (1, rid)


class _TraceJoin:
    """Cross-process request join: ``trace``-kind crumbs from EVERY
    ring (a router dir + N replica dirs), grouped by trace_id, render
    as one synthetic "trace" process — per trace, a router relay row
    plus one row per hop, so a failed-over request reads as a single
    causal track: hop-1 queue/prefill/decode cut at the failover seam,
    hop-2 resume-prefill/decode continuing it. A first hop whose
    replica was SIGKILLed never wrote a finish crumb; its decode phase
    is force-closed at the ROUTER's seam timestamp (the orphaned-
    lifecycle fix the per-process view can't make — only the router
    knows when the stream actually died)."""

    PID = 1                 # real rings start at pid 100
    TRACK_STRIDE = 8        # rows per trace: router + up to 7 hops

    def __init__(self):
        # trace_id -> [(ts, crumb, source label)]
        self._traces: Dict[str, List[Tuple[float, dict, str]]] = {}

    def feed(self, crumb: dict, ts: float, source: str) -> None:
        self._traces.setdefault(crumb["trace_id"], []).append(
            (ts, crumb, source))

    def _hop_rows(self, trace_id: str, base: int, evs) -> List[dict]:
        out: List[dict] = []
        last_ts = max(ts for ts, _, _ in evs)
        by_hop: Dict[int, List[Tuple[float, dict, str]]] = {}
        for ts, c, src in evs:
            by_hop.setdefault(min(c["hop"],
                                  self.TRACK_STRIDE - 1), []).append(
                (ts, c, src))
        short = trace_id[:8]
        for hop in sorted(by_hop):
            tid = base + hop
            row = "router" if hop == 0 else f"hop {hop}"
            out.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                        "pid": self.PID, "tid": tid,
                        "args": {"name": f"trace {short} {row}"}})
            first: Dict[str, float] = {}
            meta: Dict[str, str] = {}
            source = ""
            for ts, c, src in by_hop[hop]:
                first.setdefault(c["verb"], ts)
                if c["verb"] == "finish" and "reason" in c:
                    meta["finish_reason"] = c["reason"]
                if c["verb"] == "seam" and "tokens" in c:
                    meta["tokens_relayed"] = c["tokens"]
                if c["verb"] == "open" and "rep" in c:
                    # The ROUTER's record of which replica served this
                    # hop — survives even when that replica's ring is
                    # gone (a SIGKILLed victim's respawn truncates it).
                    meta["replica"] = c["rep"]
                if c["verb"] not in ("recv", "open", "seam",
                                     "finish"):
                    source = src      # the replica that computed
            args = {"trace_id": trace_id, **meta}
            if source:
                args["process"] = source
            if hop == 0:
                t0 = first.get("recv", by_hop[hop][0][0])
                t1 = first.get("finish", last_ts)
                out.append({"name": "relay", "ph": "X", "ts": t0,
                            "dur": max(0.0, t1 - t0),
                            "pid": self.PID, "tid": tid,
                            "args": args})
                continue
            end = first.get("finish")
            if end is None and "seam" in first:
                end = first["seam"]
                args["force_closed"] = "failover_seam"
            if end is None:
                end = last_ts
            pf = first.get("prefill", first.get("resume_prefill"))
            marks = [("queue", first.get("submit"),
                      pf if pf is not None else end),
                     ("resume_prefill" if "resume_prefill" in first
                      else "prefill", pf,
                      first.get("first_token", end)),
                     ("decode", first.get("first_token"), end)]
            for name, t0, t1 in marks:
                if t0 is None:
                    continue
                out.append({"name": name, "ph": "X", "ts": t0,
                            "dur": max(0.0, min(t1, end) - t0),
                            "pid": self.PID, "tid": tid,
                            "args": args})
            for verb in ("open", "seam", "preempt"):
                if verb in first:
                    out.append({"name": verb, "ph": "i", "s": "t",
                                "ts": first[verb], "pid": self.PID,
                                "tid": tid, "args": args})
        return out

    def finalize(self) -> List[dict]:
        if not self._traces:
            return []
        out = [{"name": "process_name", "ph": "M", "ts": 0.0,
                "pid": self.PID, "tid": 0,
                "args": {"name": "trace (cross-process join)"}}]
        for idx, trace_id in enumerate(sorted(self._traces)):
            evs = sorted(self._traces[trace_id],
                         key=lambda e: e[0])
            out.extend(self._hop_rows(trace_id,
                                      idx * self.TRACK_STRIDE, evs))
        return out


def build_timeline(run_dirs: Sequence[str]) -> dict:
    """One chrome-trace dict from any number of run dirs. Raises
    FileNotFoundError when none of them contains a flight-recorder
    ring (the timeline would be silently empty otherwise)."""
    rings: List[Tuple[str, int, str]] = []
    for d in run_dirs:
        for pidx, path in discover_rings(d):
            rings.append((d, pidx, path))
    if not rings:
        raise FileNotFoundError(
            "no flightrec events.ring under any of: "
            + ", ".join(run_dirs) + " (runs record one by default; "
            "--no-flightrec runs leave no timeline)")

    parsed = []
    t_min: Optional[float] = None
    for run_dir, pidx, path in rings:
        events = _ring.read_ring_file(path)
        for e in events:
            t_min = e["t"] if t_min is None else min(t_min, e["t"])
        parsed.append((run_dir, pidx, path, events))
    t_min = t_min or 0.0

    out_events: List[dict] = []
    join = _TraceJoin()
    for i, (run_dir, pidx, path, events) in enumerate(parsed):
        meta = _read_meta(path, pidx)
        label = os.path.basename(os.path.normpath(run_dir)) or run_dir
        if meta.get("run_id"):
            label = f"{label} ({meta['run_id']})"
        if pidx:
            label = f"{label} p{pidx}"
        track = _ProcessTrack(
            pid=(i + 1) * 100 + pidx, label=label,
            thread_names=_read_thread_names(path, pidx),
            trace_join=join)
        for e in events:
            track.feed(e, round((e["t"] - t_min) * 1e6, 3))
        out_events.extend(track.finalize())
    out_events.extend(join.finalize())

    # Metadata first, then everything else in timestamp order —
    # non-decreasing ts is part of the exported contract.
    metas = [e for e in out_events if e["ph"] == "M"]
    rest = sorted((e for e in out_events if e["ph"] != "M"),
                  key=lambda e: e["ts"])
    return {"traceEvents": metas + rest, "displayTimeUnit": "ms",
            "otherData": {"source": "tpunet flightrec",
                          "clock": "time.time (host wall clock)"}}


def write_trace(run_dirs: Sequence[str], out_path: str) -> dict:
    """Build and write ``trace.json`` (load at ui.perfetto.dev).
    Returns the trace dict."""
    trace = build_timeline(run_dirs)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, out_path)
    return trace
