"""Stdlib threaded HTTP proxy: one endpoint in front of N replicas.

A copy of ``tpunet/router/frontend.py``: the same endpoints, status
codes, headers and bodies, over the port's ``serve.httpjson``.

Endpoints:

- ``POST /v1/generate`` — picked by affinity + least-loaded and
  proxied to a replica (streaming ndjson relayed chunk-by-chunk).
  A replica that fails or answers 503/429 BEFORE any response byte
  reached the client is retried against another replica (up to
  ``route_retries`` re-routes); client errors (400/413) relay
  immediately — re-routing a bad request just fails it N times.
  Streams get MID-STREAM FAILOVER (``--failover``, default on): the
  frontend journals every relayed token, and a replica that dies
  after first bytes reached the client is replaced — the request is
  re-submitted to a survivor with ``resume_tokens`` and the client's
  stream continues with no error frame (greedy: token-identical to an
  uninterrupted run; sampled: deterministic per (seed, step) — see
  docs/serving.md "Mid-stream failover & serve-tier chaos").
- ``POST /v1/classify`` — same proxy, no affinity (stateless).
- ``POST /webhook`` — AlertWebhook receiver: straggler / crash /
  thread_stalled pages naming a replica's run_id evict it
  (``--obs-webhook http://router:PORT/webhook`` on any fleet
  dashboard or serve CLI closes the loop).
- ``GET /healthz`` — router liveness + routable-replica count (503
  only when the control loop died).
- ``GET /metrics`` — the router registry snapshot (``router_*``).
- ``GET /replicas`` — per-replica state/load/counters (the e2e tests
  and ``bench_serve --router`` read replica request counts here).

Client deadline propagation: an ``X-Deadline-Ms`` request header is
honored end-to-end — every hop (including failover retries) forwards
the REMAINING budget to the replica, and expiry before success is a
504 carrying the partial token count (mid-stream: a ``deadline`` done
frame).

With no routable replica the router answers 503 with ``Retry-After:
1`` — the same backpressure contract the replicas themselves speak.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpunet_torch.obs import flightrec, tracing
from tpunet_torch.router import replica as rstate
from tpunet_torch.router.core import Router
from tpunet_torch.serve import httpjson

#: Relay poll period while a stream is quiet: bounds how long a
#: wedged-but-connected replica can hold a stream before the relay
#: notices its eviction (the stall-evict -> failover path).
_STREAM_POLL_S = 0.5


class _StreamReader:
    """Line reader for one upstream response on its own thread.

    http.client response objects cannot be poll-read: a socket
    timeout permanently poisons them ("cannot read from timed out
    object"), so the relay blocks a dedicated reader in
    ``readline()`` and polls its queue instead — replica-eviction and
    deadline checks run between polls, and abandoning a wedged stream
    is just closing the response (the blocked read unblocks and the
    thread exits)."""

    _registered = False

    def __init__(self, resp):
        import queue
        self._resp = resp
        self._q: "queue.Queue" = queue.Queue()
        self._empty = queue.Empty
        # One inventory-only registration (stall budget 0) for the
        # whole relay-reader population, like the router-http
        # listener: readers legitimately block in readline for a
        # stream's lifetime, and per-stream handles would leave a
        # stale never-beating entry per request in the process-global
        # registry.
        if not _StreamReader._registered:
            _StreamReader._registered = True
            flightrec.register_thread("router-relay")
        self._thread = threading.Thread(
            target=self._run, args=(resp,), daemon=True,
            name="tpunet-router-relay")
        self._thread.start()

    def _run(self, resp) -> None:
        try:
            while True:
                line = resp.readline()
                self._q.put(("line", line))
                if not line:
                    return
        except Exception as e:  # noqa: BLE001 — any read failure is
            # the same relay signal: the stream is over.
            self._q.put(("exc", e))

    def get(self, timeout: float):
        """("line", bytes) / ("exc", exception) / None on poll
        timeout. A b"" line is upstream EOF."""
        try:
            return self._q.get(timeout=timeout)
        except self._empty:
            return None

    def close(self) -> None:
        """Tear the stream down even when the reader is still blocked
        mid-readline (a wedged replica): ``resp.close()`` alone would
        deadlock on the buffered reader's lock, so the SOCKET is shut
        down first — the blocked recv returns EOF, the thread exits,
        and only then is the response closed. A reader that still
        won't die keeps its response leaked (daemon thread) rather
        than deadlocking the relay."""
        import socket
        sock = getattr(getattr(self._resp, "fp", None), "raw", None)
        sock = getattr(sock, "_sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(timeout=2.0)
        if self._thread.is_alive():
            return
        try:
            self._resp.close()
        except Exception:  # noqa: BLE001
            pass


class RouterServer:
    """Owns the Router and the HTTP listener (``port=0`` binds an
    ephemeral port for tests)."""

    def __init__(self, router: Router, *, host: str = "127.0.0.1",
                 port: int = 8100, metrics_logger=None, exporters=(),
                 flight_recorder=None):
        self.router = router
        self.registry = router.registry
        self._metrics_logger = metrics_logger
        self._exporters = list(exporters)
        self._flightrec = flight_recorder
        self._drained = False
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._serve_thread: Optional[threading.Thread] = None
        self.prober = None

    def start(self) -> "RouterServer":
        self.router.start()
        # Inventory-only (stall budget 0), like the serve listener:
        # serve_forever blocks in accept() and cannot beat.
        flightrec.register_thread("router-http")
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="tpunet-router-http")
        self._serve_thread.start()
        cfg = self.router.cfg
        if getattr(cfg, "probe_every_s", 0.0) > 0 \
                and self.router.slo is not None:
            # The canary probes the router's PUBLIC endpoint — the
            # full proxy path — via loopback (the prober lives in the
            # router process; a wildcard bind still answers there).
            from tpunet_torch.router.prober import Prober
            host = cfg.host
            if host in ("", "0.0.0.0", "::"):
                host = "127.0.0.1"
            self.prober = Prober(
                cfg, self.router.slo, registry=self.registry,
                base_url=f"http://{host}:{self.port}").start()
        return self

    def drain(self) -> None:
        """Stop listening, stop the control loop, drain supervised
        children, flush sinks. Idempotent. In-flight failovers are
        waited for inside ``Router.drain`` against the shared grace
        budget — the journal is never orphaned with its frontend
        thread."""
        if self._drained:
            return
        self._drained = True
        flightrec.record("router", "frontend drain")
        if self.prober is not None:
            self.prober.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.router.drain()
        for exporter in self._exporters:
            try:
                exporter.close()
            except Exception:  # noqa: BLE001 — a dead endpoint must
                pass           # not block shutdown
        if self._flightrec is not None:
            flightrec.close(self._flightrec)
            self._flightrec = None

    close = drain


def _make_handler(server: RouterServer):
    router = server.router
    cfg = router.cfg

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102 — metrics
            pass                            # carry the signal

        # -- helpers ---------------------------------------------------

        def _json(self, code: int, obj: dict, headers=()) -> None:
            httpjson.write_json(self, code, obj, headers)

        def _read_body(self) -> dict:
            return httpjson.read_json_body(self)

        def _client_deadline(self) -> Optional[float]:
            """Absolute monotonic deadline from the client's
            ``X-Deadline-Ms`` header (None when absent; raises
            ValueError on garbage)."""
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr is None:
                return None
            ms = float(hdr)               # ValueError -> 400
            if ms <= 0:
                raise ValueError(
                    f"X-Deadline-Ms must be positive, got {hdr!r}")
            return time.monotonic() + ms / 1e3

        def _trace_context(self):
            """(trace_id, sampled) for this request (tpunet_torch/obs/
            tracing.py): a client-supplied valid ``X-Trace-Id`` is
            adopted and always sampled (explicit opt-in); otherwise a
            fresh id is minted and head-sampled at
            ``cfg.trace_sample``. ("", False) when tracing is fully
            off — call sites short-circuit on the empty id."""
            tid = self.headers.get(tracing.TRACE_HEADER)
            if tracing.valid_trace_id(tid):
                return tid, True
            if cfg.trace_sample <= 0 and not cfg.trace_all_on_error:
                return "", False
            tid = tracing.mint_trace_id()
            return tid, tracing.should_sample(cfg.trace_sample, tid)

        @staticmethod
        def _replica_headers(deadline_t: Optional[float],
                             trace=None) -> dict:
            """Headers for one replica-bound request: the remaining
            deadline budget rides along so the engine's scheduler
            enforces the CLIENT's clock, and a failover retry can
            never exceed the original budget. A sampled trace context
            (``trace``: anything with trace_id/trace_sampled/hop —
            a JournalEntry or the _proxy shim) stamps the trace
            headers on the hop, failover re-submits included."""
            headers = {"Content-Type": "application/json"}
            if deadline_t is not None:
                remaining = max(1.0,
                                1e3 * (deadline_t - time.monotonic()))
                headers["X-Deadline-Ms"] = f"{remaining:.0f}"
            if trace is not None and trace.trace_sampled:
                headers[tracing.TRACE_HEADER] = trace.trace_id
                headers[tracing.SAMPLED_HEADER] = "1"
                headers[tracing.HOP_HEADER] = str(trace.hop)
            return headers

        # -- GET -------------------------------------------------------

        def do_GET(self):  # noqa: N802 (stdlib handler API)
            if self.path == "/healthz":
                routable = sum(1 for r in router.replicas
                               if r.routable())
                if not router.healthy:
                    self._json(503, {
                        "status": "unhealthy",
                        "error": router.error or "control loop dead"})
                else:
                    self._json(200, {
                        "status": "ok" if routable else "no_replicas",
                        "replicas": len(router.replicas),
                        "routable": routable})
                return
            if self.path == "/metrics":
                self._json(200, server.registry.snapshot())
                return
            if self.path == "/replicas":
                self._json(200, {"replicas": router.replicas_view()})
                return
            self._json(404, {"error": "not found"})

        # -- POST ------------------------------------------------------

        def do_POST(self):  # noqa: N802
            try:
                body = self._read_body()
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            if self.path == "/v1/generate":
                if body.get("stream") and cfg.failover:
                    self._generate_stream(body)
                else:
                    self._proxy(body, "/v1/generate",
                                stream=bool(body.get("stream")),
                                affine=True)
            elif self.path == "/v1/classify":
                self._proxy(body, "/v1/classify", stream=False,
                            affine=False)
            elif self.path == "/webhook":
                accepted = router.on_page(body)
                self._json(200, {"accepted": accepted})
            else:
                self._json(404, {"error": "not found"})

        # -- replica connection (pre-first-byte retry loop) ------------

        def _open_on_fleet(self, body: dict, path: str, tried: set,
                           *, affine: bool,
                           deadline_t: Optional[float], trace=None):
            """Pick a replica and open the request, re-routing around
            dead/draining replicas BEFORE any response byte exists.
            Returns one of::

                ("resp", resp, rep)        connection open, routed
                ("relay", code, payload)   live replica's own error —
                                           relay verbatim
                ("reject", code, payload, headers)
                                           exhausted / expired

            Every OPEN attempt is one trace hop: ``trace.hop``
            increments per attempt (route retries and failover
            re-submits alike), so the headers a replica sees name the
            span its breadcrumbs belong to.
            """
            raw = json.dumps(body).encode()
            last_error = None
            for _ in range(cfg.route_retries + 1):
                if deadline_t is not None \
                        and time.monotonic() >= deadline_t:
                    return ("reject", 504,
                            {"error": "deadline", "n_tokens": 0}, ())
                rep, _hit = (router.pick(body, exclude=tried) if affine
                             else router.pick({}, exclude=tried))
                if rep is None:
                    break
                if trace is not None and trace.trace_sampled:
                    trace.hop += 1
                req = urllib.request.Request(
                    rep.url + path, raw,
                    self._replica_headers(deadline_t, trace))
                try:
                    resp = urllib.request.urlopen(
                        req, timeout=cfg.request_timeout_s)
                except urllib.error.HTTPError as e:
                    if e.code in (503, 429):
                        # Draining / overloaded: honor Retry-After,
                        # re-route to another replica.
                        retry_after = float(
                            e.headers.get("Retry-After") or 0)
                        if retry_after > 0:
                            rep.backoff(retry_after)
                        e.read()
                        e.close()
                        tried.add(rep.name)
                        router.note_rerouted(rep)
                        last_error = (e.code,
                                      {"error": "replica_busy",
                                       "replica": rep.name})
                        continue
                    # Client/server error from a live replica: relay
                    # verbatim (re-routing a 400 fails it N times).
                    router.note_routed(rep)
                    try:
                        payload = json.loads(e.read())
                    except Exception:  # noqa: BLE001
                        payload = {"error":
                                   f"replica returned {e.code}"}
                    e.close()
                    return ("relay", e.code, payload)
                except Exception:  # noqa: BLE001 — connection refused/
                    # reset/timeout: the replica is gone; probe it off-
                    # cadence and try another.
                    tried.add(rep.name)
                    router.note_rerouted(rep)
                    router.replica_failed(rep)
                    last_error = (502, {"error": "replica_unreachable",
                                        "replica": rep.name})
                    continue
                router.note_routed(rep)
                if trace is not None and trace.trace_sampled:
                    tracing.crumb("open", trace.trace_id, trace.hop,
                                  rep=rep.name)
                return ("resp", resp, rep)
            router.note_rejected(synthetic=bool(body.get("probe")))
            code, payload = last_error or (
                503, {"error": "no_replicas",
                      "detail": "no routable replica"})
            return ("reject", code, payload, (("Retry-After", "1"),))

        # -- non-stream proxying ---------------------------------------

        def _proxy(self, body: dict, path: str, *, stream: bool,
                   affine: bool) -> None:
            t0 = time.perf_counter()
            try:
                deadline_t = self._client_deadline()
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            # Non-journal paths still propagate trace context so the
            # replica's span exists; the router-hop record is a
            # stream-path concern (the relay owns the e2e story).
            tid, sampled = self._trace_context()
            trace = (types.SimpleNamespace(
                trace_id=tid, trace_sampled=sampled, hop=0)
                if tid else None)
            synthetic = bool(body.get("probe"))
            tried: set = set()
            while True:
                opened = self._open_on_fleet(body, path, tried,
                                             affine=affine,
                                             deadline_t=deadline_t,
                                             trace=trace)
                if opened[0] == "relay":
                    _, code, payload = opened
                    self._json(code, payload)
                    return
                if opened[0] == "reject":
                    _, code, payload, headers = opened
                    self._json(code, payload, headers=headers)
                    return
                _, resp, rep = opened
                if stream:
                    # Legacy (--no-failover) stream relay: a replica
                    # death mid-stream ends the stream with an honest
                    # error frame and the client retries.
                    try:
                        self._relay_stream(resp)
                    finally:
                        resp.close()
                        router.observe_e2e(time.perf_counter() - t0,
                                           synthetic=synthetic)
                    return
                # Non-stream: buffer the WHOLE body before the first
                # client byte — a replica death mid-read is then fully
                # retryable on another replica (nothing was sent, and
                # generation is deterministic per (seed, step)).
                try:
                    payload = resp.read()
                    status = resp.status
                except (OSError, http.client.HTTPException):
                    resp.close()
                    tried.add(rep.name)
                    router.note_rerouted(rep)
                    router.replica_failed(rep)
                    continue
                resp.close()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                router.observe_e2e(time.perf_counter() - t0,
                                   synthetic=synthetic)
                return

        # -- streaming with mid-stream failover ------------------------

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode()
                             + data + b"\r\n")
            self.wfile.flush()

        def _finish_frame(self, entry, reason: str,
                          error: Optional[str] = None) -> None:
            """Terminate the client stream with a router-authored done
            frame (degradation paths: journal cap, retries exhausted,
            deadline). Client disconnects are swallowed — there is
            nobody left to tell."""
            frame = {"done": True, "finish_reason": reason,
                     "n_tokens": len(entry.tokens)}
            if entry.failover_count:
                frame["failover_count"] = entry.failover_count
            if error:
                frame["error"] = error
            try:
                self._chunk((json.dumps(frame) + "\n").encode())
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

        def _close_trace(self, entry, reason: str, t0: float,
                         error: str = "") -> None:
            """Close the router-hop trace span: a ``finish`` crumb
            plus one router-role ``obs_trace`` record — for every
            sampled request, and (trace-all-on-error tail capture) for
            any UNsampled request that failed over or errored. The
            empty-trace_id check is the whole cost on the untraced
            path."""
            if not entry.trace_id:
                return
            interesting = bool(entry.failover_count or error
                               or reason == "error")
            if not (entry.trace_sampled
                    or (cfg.trace_all_on_error and interesting)):
                return
            if entry.trace_sampled:
                tracing.crumb("finish", entry.trace_id, 0,
                              reason=reason)
            router.note_trace(tracing.build_trace_record(
                trace_id=entry.trace_id, hop=0, role="router",
                finish_reason=reason, tokens=len(entry.tokens),
                failover_count=entry.failover_count,
                tokens_relayed=entry.tokens_relayed,
                e2e_s=time.perf_counter() - t0, error=error))

        def _generate_stream(self, body: dict) -> None:
            """Streamed /v1/generate with mid-stream failover: journal
            every relayed token; on replica death after first bytes,
            resume on a survivor via ``resume_tokens`` — the client
            stream continues with no error frame. Degradations (all
            end in an honest frame, never a silent truncation):
            journal over cap, failover retries exhausted, no surviving
            replica, resume rejected, deadline expiry."""
            t0 = time.perf_counter()
            try:
                deadline_t = self._client_deadline()
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            entry = router.journal.open(body, deadline_t)
            entry.trace_id, entry.trace_sampled = \
                self._trace_context()
            if entry.trace_sampled:
                tracing.crumb("recv", entry.trace_id, 0)
            self._finish_reason = ""
            try:
                tried: set = set()
                opened = self._open_on_fleet(body, "/v1/generate",
                                             tried, affine=True,
                                             deadline_t=deadline_t,
                                             trace=entry)
                if opened[0] == "relay":
                    self._json(opened[1], opened[2])
                    return
                if opened[0] == "reject":
                    self._json(opened[1], opened[2],
                               headers=opened[3])
                    return
                _, resp, rep = opened
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while True:
                    outcome = self._relay_journal_stream(entry, resp,
                                                         rep)
                    resp.close()
                    if outcome == "done":
                        router.observe_e2e(time.perf_counter() - t0,
                                           synthetic=bool(
                                               body.get("probe")))
                        self._close_trace(
                            entry, self._finish_reason or "done", t0)
                        return
                    if outcome == "client_gone":
                        flightrec.record(
                            "router", "client gone mid-stream")
                        self._close_trace(entry, "cancelled", t0,
                                          "client gone mid-stream")
                        return
                    if outcome == "deadline":
                        self._finish_frame(entry, "deadline")
                        self._close_trace(entry, "deadline", t0)
                        return
                    # outcome == "failed": the serving replica died
                    # (or wedged into eviction) mid-stream. This is a
                    # FAILOVER, not a pre-first-byte re-route —
                    # router_failovers_total (note_failover below) is
                    # its counter; only the per-replica failure
                    # accounting rides here.
                    tried.add(rep.name)
                    rep.note_failed()
                    router.replica_failed(rep)
                    if entry.over_cap:
                        self._finish_frame(
                            entry, "error",
                            "replica failed mid-stream past the "
                            f"failover journal cap "
                            f"({router.journal.max_tokens} tokens); "
                            "retry the request")
                        self._close_trace(entry, "error", t0,
                                          "journal over cap")
                        return
                    if entry.failover_count >= cfg.failover_retries:
                        self._finish_frame(
                            entry, "error",
                            "replica failed mid-stream and the "
                            f"failover budget "
                            f"({cfg.failover_retries}) is exhausted")
                        self._close_trace(entry, "error", t0,
                                          "failover budget exhausted")
                        return
                    if deadline_t is not None \
                            and time.monotonic() >= deadline_t:
                        self._finish_frame(entry, "deadline")
                        self._close_trace(entry, "deadline", t0)
                        return
                    router.journal.begin_failover(entry)
                    router.note_failover(rep,
                                         tokens=len(entry.tokens))
                    if entry.trace_sampled:
                        # The failover seam, on the ROUTER's clock:
                        # the timeline join pins the first hop's
                        # orphaned lifecycle closed here.
                        tracing.crumb("seam", entry.trace_id,
                                      entry.hop,
                                      tokens=len(entry.tokens),
                                      rep=rep.name)
                    opened = self._open_on_fleet(
                        entry.resume_body(), "/v1/generate", tried,
                        affine=True, deadline_t=deadline_t,
                        trace=entry)
                    if opened[0] != "resp":
                        router.journal.end_failover(entry)
                        detail = opened[2]
                        reason = ("deadline"
                                  if detail.get("error") == "deadline"
                                  else "error")
                        self._finish_frame(
                            entry, reason,
                            None if reason == "deadline" else
                            "replica failed mid-stream and no "
                            f"survivor could resume: {detail}")
                        self._close_trace(
                            entry, reason, t0,
                            "" if reason == "deadline" else
                            "no survivor could resume")
                        return
                    _, resp, rep = opened
                    # Resumed stream open: the request is in-flight on
                    # the survivor again (a graceful drain now covers
                    # it), so the failover window closes here.
                    router.journal.end_failover(entry)
            finally:
                router.journal.close(entry)

        def _relay_journal_stream(self, entry, resp, rep) -> str:
            """Relay one replica's ndjson stream, journaling every
            token. Returns ``done`` (final frame relayed), ``failed``
            (replica died / wedged-evicted / torn line — failover
            decision is the caller's), ``deadline`` (client budget
            expired while the stream was quiet), or ``client_gone``.

            Duplicate suppression at the kill seam: token events carry
            their index in the generated sequence (``i``, falling back
            to arrival order); an index below the journal length was
            already relayed by the previous replica — e.g. the token
            it emitted as it died — and is dropped, so the client sees
            every index exactly once."""
            reader = _StreamReader(resp)
            try:
                return self._relay_lines(entry, reader, rep)
            finally:
                reader.close()

        def _relay_lines(self, entry, reader, rep) -> str:
            base = len(entry.tokens)
            seen = 0
            while True:
                got = reader.get(_STREAM_POLL_S)
                if got is None:           # stream quiet: poll state
                    if rep.state in (rstate.DEAD, rstate.EVICTED):
                        flightrec.record(
                            "router",
                            f"stream owner {rep.name} evicted "
                            "mid-relay")
                        return "failed"
                    remaining = entry.remaining_ms()
                    if remaining is not None and remaining <= 0:
                        return "deadline"
                    continue
                kind, line = got
                if kind == "exc":
                    # Socket reset OR chunked framing cut mid-chunk
                    # (IncompleteRead) — both are the replica dying.
                    flightrec.record("router", "stream relay broke")
                    return "failed"
                if not line:
                    # EOF without a done frame: the replica's frontend
                    # died between tokens.
                    return "failed"
                try:
                    ev = json.loads(line)
                except ValueError:
                    # Torn line at the death seam: never relay bytes
                    # the journal cannot account for.
                    return "failed"
                if "token" in ev:
                    idx = ev.get("i")
                    if idx is None:
                        idx = base + seen
                    seen += 1
                    if idx < len(entry.tokens):
                        continue           # duplicate: suppress
                    router.journal.note_token(entry, ev["token"])
                    try:
                        self._chunk(line)
                    except OSError:
                        return "client_gone"
                    continue
                if ev.get("done"):
                    self._finish_reason = str(
                        ev.get("finish_reason") or "")
                    if entry.failover_count:
                        ev["failover_count"] = entry.failover_count
                        line = (json.dumps(ev) + "\n").encode()
                    try:
                        self._chunk(line)
                        self.wfile.write(b"0\r\n\r\n")
                    except OSError:
                        return "client_gone"
                    return "done"
                # Unknown frame kinds relay verbatim (forward compat).
                try:
                    self._chunk(line)
                except OSError:
                    return "client_gone"

        def _relay_stream(self, resp) -> None:
            """Legacy (--no-failover) relay: replica ndjson chunk-by-
            chunk (urllib de-chunks the replica side; we re-chunk
            toward the client). A replica death mid-stream ends the
            stream with an error done-frame — tokens already forwarded
            cannot be unsent; the client retries and lands on a live
            replica."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for line in resp:
                    self._chunk(line)
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                raise
            except (OSError, http.client.HTTPException):
                # Replica-side failure mid-relay: close the stream
                # honestly (the flight recorder notes it; the done
                # frame says error, not length).
                flightrec.record("router", "stream relay broke")
                try:
                    self._chunk(json.dumps(
                        {"done": True, "finish_reason": "error",
                         "error": "replica failed mid-stream"})
                        .encode() + b"\n")
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

    return Handler
