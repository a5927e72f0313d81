"""Stdlib-only threaded HTTP frontend for the serving engine, port of
``tpunet/serve/frontend.py``: the same endpoints, status codes, headers
and bodies byte for byte, so the JAX package's router
(``python -m tpunet.router --replica``) can front a port replica.

Endpoints:

- ``POST /v1/generate`` — body ``{"prompt": "text"}`` (byte-level
  vocab-256 checkpoints) or ``{"tokens": [ids]}``, plus optional
  ``max_new_tokens``, ``temperature``, ``top_k``, ``top_p``, ``seed``,
  ``deadline_s``, ``stop_token``, ``stream``. Non-streaming returns one
  JSON object; ``"stream": true`` returns ndjson token events
  (``{"token": id, "text": "..."}`` per line, then a final
  ``{"done": true, ...}`` line) flushed as they are produced.
- ``POST /v1/classify`` — ``{"image": [[[u8,..]]]}`` nested HWC list
  (or ``{"image_b64": "...", "shape": [H, W, 3]}`` raw RGB bytes),
  optional ``topk``; micro-batched across concurrent requests.
- ``GET /healthz`` — 200 while the engine loop is alive and admitting;
  503 "unhealthy" (with the error) once the engine thread died, 503
  "draining" with ``Retry-After`` while the server drains — an
  orchestrator restarts the pod instead of watching a silent hang. A
  loop that ended through the drain path with no error is draining,
  not dead (``Engine.healthy``), whichever of the loop's end and the
  probe comes first.
- ``GET /metrics`` — flat JSON snapshot of the serve registry
  (counters, gauges, histogram percentiles).

Backpressure maps to status codes: 429 queue-full, 503 draining/dead,
413 prompt-too-long. The server drains gracefully: ``drain()`` stops
admissions, lets in-flight requests finish (bounded), flushes the
exporters and the metrics log, then stops the listener. Serve-tier
chaos (``--chaos``, ``tpunet_torch/serve/chaos.py``) fires its probe hook
in ``/healthz`` and its stream hook before each relayed ndjson line.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from tpunet_torch.obs import flightrec, tracing
from tpunet_torch.serve import httpjson
from tpunet_torch.serve.engine import Engine, PromptTooLongError
from tpunet_torch.serve.scheduler import DrainingError, QueueFullError


def _token_text(tokens, vocab_size: int) -> Optional[str]:
    """Byte-level checkpoints (vocab 256) round-trip UTF-8; other
    vocabs have no text form."""
    if vocab_size != 256:
        return None
    return bytes(np.clip(np.asarray(tokens, np.int64), 0, 255)
                 .astype(np.uint8)).decode("utf-8", errors="replace")


class ServeServer:
    """Owns the engine, optional classifier batcher, obs sinks, and the
    HTTP listener. ``port=0`` binds an ephemeral port (tests)."""

    def __init__(self, engine: Engine, *, classify_batcher=None,
                 host: str = "127.0.0.1", port: int = 8000,
                 metrics_logger=None, exporters=(), run_id: str = "",
                 flight_recorder=None):
        self.engine = engine
        self.classify = classify_batcher
        self.registry = engine.registry
        if not self.registry.identity():
            # Replica identity on every obs_serve record: the fleet
            # aggregator routes replica streams by it (one replica =
            # one run_id). serve has no checkpoint-persisted id, so
            # the default is host+pid — stable for the server's life,
            # unique across replicas on one host.
            import os
            import socket
            self.registry.set_identity(
                run_id=run_id or f"serve-{socket.gethostname()}"
                                 f"-{os.getpid()}",
                process_index=0, host=socket.gethostname())
        self.vocab_size = int(engine.model.vocab_size)
        self._metrics_logger = metrics_logger
        self._exporters = list(exporters)
        # Flight recorder owned by this server's process (installed by
        # the serve entry when a metrics dir exists); drain marks the
        # clean shutdown so the watcher never fabricates a crash.
        self._flightrec = flight_recorder
        self._drained = False
        # Chaos: live stream relays, request id -> [request, token lines
        # written]. A kill waits for them (``_flush_relays``), so the token
        # that triggered it reaches its client first.
        self._relays: dict = {}
        self._relay_cv = threading.Condition()
        if engine.chaos is not None:
            engine.chaos.before_kill = self._flush_relays
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._serve_thread: Optional[threading.Thread] = None

    def start(self) -> "ServeServer":
        self.engine.start()
        # Host-thread registry: inventory-only (stall budget 0 —
        # serve_forever blocks in accept(), so it cannot beat; liveness
        # is the /healthz contract, but the thread must still show up
        # in crash reports and thread_* gauges).
        flightrec.register_thread("serve-http")
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="tpunet-serve-http")
        self._serve_thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """SIGTERM path: stop admitting, finish in-flight, flush obs,
        stop listening. Idempotent."""
        if self._drained:
            return True
        self._drained = True
        flightrec.record("serve", "frontend drain")
        ok = self.engine.drain(timeout)
        for exporter in self._exporters:
            try:
                exporter.close()
            except Exception:  # noqa: BLE001 — a dead endpoint must
                pass           # not block shutdown
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.classify is not None:
            self.classify.close()
        if self._flightrec is not None:
            flightrec.close(self._flightrec)
            self._flightrec = None
        return ok

    close = drain

    def _relay_note(self, req, written: Optional[int]) -> None:
        """A chaos-armed stream relay's progress: ``written`` token lines
        sent for ``req``, or None when its relay ended."""
        with self._relay_cv:
            if written is None:
                self._relays.pop(req.id, None)
            else:
                self._relays[req.id] = (req, written)
            self._relay_cv.notify_all()

    def _flush_relays(self, timeout: float = 5.0) -> None:
        """Wait (at most ``timeout`` s) until every live stream relay has
        written every token its request holds."""
        with self._relay_cv:
            self._relay_cv.wait_for(lambda: all(
                n >= len(req.tokens) - req.resume_offset
                for req, n in self._relays.values()), timeout)


def _make_handler(server: ServeServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Quiet by default: per-request stderr lines are noise at
        # serving rates; metrics carry the signal.

        def log_message(self, fmt, *args):  # noqa: D102
            pass

        # -- helpers ---------------------------------------------------

        def _json(self, code: int, obj: dict, headers=()) -> None:
            httpjson.write_json(self, code, obj, headers)

        def _retry_after(self):
            """503-draining responses carry Retry-After (seconds until
            this replica is expected back): the router backs the
            replica off for exactly that long instead of hammering a
            drain with requests it will reject."""
            return (("Retry-After",
                     str(max(1, int(server.engine.cfg.drain_timeout_s)))),)

        def _read_body(self) -> dict:
            return httpjson.read_json_body(self)

        # -- GET -------------------------------------------------------

        def do_GET(self):  # noqa: N802 (stdlib handler API)
            if self.path == "/healthz":
                engine = server.engine
                # Chaos injection: a standing stall wedges the probe (the
                # router's stall-evict path); drop-probe answers 500 on
                # the seeded draws.
                if engine.chaos is not None \
                        and engine.chaos.on_probe():
                    self._json(500, {"error": "chaos: probe dropped"})
                    return
                run_id = server.registry.identity().get("run_id", "")
                if engine.error is not None or not engine.healthy:
                    self._json(503, {
                        "status": "unhealthy", "run_id": run_id,
                        "error": engine.error or "engine thread dead"})
                elif engine.draining:
                    self._json(503, {"status": "draining",
                                     "run_id": run_id},
                               headers=self._retry_after())
                else:
                    self._json(200, {
                        "status": "ok", "run_id": run_id,
                        "active_slots": engine.active_slots(),
                        "queue_depth": engine.queue.depth(),
                        "slots": engine.slots})
                return
            if self.path == "/metrics":
                self._json(200, server.registry.snapshot())
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
                self._generate(body)
            elif self.path == "/v1/classify":
                self._classify(body)
            else:
                self._json(404, {"error": "not found"})

        def _parse_prompt(self, body: dict) -> np.ndarray:
            if "tokens" in body:
                toks = np.asarray(body["tokens"], np.int32).reshape(-1)
            elif "prompt" in body:
                if server.vocab_size != 256:
                    raise ValueError(
                        "text prompts need a byte-level (vocab 256) "
                        "checkpoint; send token ids as 'tokens'")
                toks = np.frombuffer(
                    str(body["prompt"]).encode("utf-8"),
                    np.uint8).astype(np.int32)
            else:
                raise ValueError("body needs 'prompt' or 'tokens'")
            if toks.size == 0:
                raise ValueError("prompt must be non-empty")
            if toks.min() < 0 or toks.max() >= server.vocab_size:
                raise ValueError(
                    f"token ids outside [0, {server.vocab_size})")
            return toks

        def _parse_resume(self, body: dict):
            """``resume_tokens`` (router mid-stream failover): token
            ids another replica already generated and streamed —
            validated like a prompt, but allowed to be absent."""
            if body.get("resume_tokens") is None:
                return None
            resume = np.asarray(body["resume_tokens"],
                                np.int32).reshape(-1)
            if resume.size and (resume.min() < 0
                                or resume.max() >= server.vocab_size):
                raise ValueError(
                    f"resume_tokens ids outside "
                    f"[0, {server.vocab_size})")
            return resume.tolist()

        def _deadline_s(self, body: dict) -> float:
            """Effective wall-clock deadline: the ``X-Deadline-Ms``
            header (the router propagates the client's original
            budget through every failover hop) and the body's
            ``deadline_s`` compose as the TIGHTER of the two."""
            body_s = float(body.get("deadline_s", 0.0))
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr is None:
                return body_s
            hdr_s = float(hdr) / 1e3
            if hdr_s <= 0:
                raise ValueError(
                    f"X-Deadline-Ms must be positive, got {hdr!r}")
            return min(body_s, hdr_s) if body_s > 0 else hdr_s

        def _trace_context(self):
            """(trace_id, hop) for this request (tpunet_torch/obs/
            tracing.py). A router upstream decides: its trace headers
            are adopted verbatim (``X-Trace-Sampled: 0`` would mean
            unsampled, but the router only stamps sampled hops).
            Standalone — no trace headers — a client-supplied
            ``X-Trace-Id`` is always sampled, and ``--trace-sample``
            head-samples the rest locally. ("", 0) = unsampled."""
            tid = self.headers.get(tracing.TRACE_HEADER)
            if tracing.valid_trace_id(tid):
                sampled = self.headers.get(tracing.SAMPLED_HEADER)
                if sampled is not None and sampled != "1":
                    return "", 0
                hop = self.headers.get(tracing.HOP_HEADER, "1")
                return tid, (int(hop) if hop.isdigit() else 1)
            rate = server.engine.cfg.trace_sample
            if rate > 0:
                tid = tracing.mint_trace_id()
                if tracing.should_sample(rate, tid):
                    return tid, 1
            return "", 0

        def _generate(self, body: dict) -> None:
            try:
                toks = self._parse_prompt(body)
                kw = {}
                if body.get("max_new_tokens") is not None:
                    # pass through verbatim: the engine defaults a
                    # MISSING budget and rejects an invalid one (0 ->
                    # ValueError -> 400), never silently substitutes.
                    kw["max_new_tokens"] = int(body["max_new_tokens"])
                resume = self._parse_resume(body)
                if resume is not None:
                    kw["resume_tokens"] = resume
                kw["trace_id"], kw["trace_hop"] = \
                    self._trace_context()
                req = server.engine.submit(
                    toks, **kw,
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 0.0)),
                    seed=int(body.get("seed", 0)),
                    deadline_s=self._deadline_s(body),
                    stop_token=int(body["stop_token"])
                    if body.get("stop_token") is not None else None)
            except QueueFullError as e:
                self._json(429, {"error": "queue_full",
                                 "detail": str(e)})
                return
            except DrainingError as e:
                self._json(503, {"error": "draining", "detail": str(e)},
                           headers=self._retry_after())
                return
            except PromptTooLongError as e:
                self._json(413, {"error": "prompt_too_long",
                                 "detail": str(e)})
                return
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            if body.get("stream"):
                self._stream_response(req)
            else:
                self._sync_response(req)

        def _sync_response(self, req) -> None:
            try:
                tokens = req.result(timeout=600.0)
            except TimeoutError:
                req.cancel()
                self._json(504, {"error": "timeout"})
                return
            out = {
                "id": req.id,
                "tokens": tokens,
                "finish_reason": req.finish_reason,
                # The EFFECTIVE generation budget after the admission
                # clamp (operator cap / KV length) — a response shorter
                # than the ask is attributable to the clamp, not a bug.
                "max_new_tokens": req.max_new_tokens,
                "ttft_ms": round(1e3 * req.ttft_s, 3)
                if req.ttft_s is not None else None,
                "e2e_ms": round(1e3 * req.e2e_s, 3)
                if req.e2e_s is not None else None,
            }
            if req.requested_max_new_tokens != req.max_new_tokens:
                out["requested_max_new_tokens"] = \
                    req.requested_max_new_tokens
            text = _token_text(tokens, server.vocab_size)
            if text is not None:
                out["text"] = text
            if req.error:
                out["error"] = req.error
            self._json(200 if req.finish_reason != "error" else 500, out)

        def _stream_response(self, req) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj: dict) -> None:
                line = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(line):x}\r\n".encode()
                                 + line + b"\r\n")
                self.wfile.flush()

            # Every token event carries its index in the GENERATED
            # sequence ("i"): a resumed request starts at its resume
            # offset, so the router's failover relay can suppress a
            # duplicate at the kill seam by index instead of guessing.
            chaos = server.engine.chaos
            idx = req.resume_offset
            if chaos is not None:
                server._relay_note(req, 0)
            try:
                for kind, val in req.events(timeout=600.0):
                    if chaos is not None:
                        chaos.on_stream_line()   # slow-stream injection
                    if kind == "token":
                        ev = {"token": val, "i": idx}
                        idx += 1
                        text = _token_text([val], server.vocab_size)
                        if text is not None:
                            ev["text"] = text
                        chunk(ev)
                        if chaos is not None:
                            server._relay_note(req, idx - req.resume_offset)
                    else:
                        done = {"done": True, "finish_reason": val,
                                "n_tokens": len(req.tokens),
                                "max_new_tokens": req.max_new_tokens,
                                "ttft_ms": round(1e3 * req.ttft_s, 3)
                                if req.ttft_s is not None else None}
                        if req.requested_max_new_tokens \
                                != req.max_new_tokens:
                            done["requested_max_new_tokens"] = \
                                req.requested_max_new_tokens
                        chunk(done)
                self.wfile.write(b"0\r\n\r\n")
            except TimeoutError:
                # Wedged engine: free the slot and tell the (still
                # connected) client before terminating the stream.
                req.cancel()
                try:
                    chunk({"done": True, "finish_reason": "error",
                           "error": "timed out waiting for the engine"})
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass
            except (BrokenPipeError, ConnectionResetError, OSError):
                # Client went away mid-stream: free the slot. The
                # disconnect is a lifecycle event too — on the unified
                # timeline a decode phase ending in "cancelled" with a
                # client_gone mark next to it reads as the client's
                # fault, not the engine's.
                flightrec.record("req", f"client_gone {req.id}")
                req.cancel()
            finally:
                if chaos is not None:
                    server._relay_note(req, None)

        def _classify(self, body: dict) -> None:
            if server.classify is None:
                self._json(503, {"error": "no classifier configured"})
                return
            try:
                if "image_b64" in body:
                    shape = tuple(body.get("shape") or ())
                    if len(shape) != 3 or shape[2] != 3:
                        raise ValueError(
                            "'image_b64' needs 'shape': [H, W, 3]")
                    raw = base64.b64decode(body["image_b64"])
                    img = np.frombuffer(raw, np.uint8)
                    if img.size != shape[0] * shape[1] * 3:
                        raise ValueError(
                            f"image_b64 has {img.size} bytes, shape "
                            f"{shape} needs {shape[0]*shape[1]*3}")
                    img = img.reshape(shape)
                elif "image" in body:
                    img = np.asarray(body["image"])
                    if img.ndim != 3 or img.shape[-1] != 3:
                        raise ValueError("'image' must be HWC with 3 "
                                         "channels")
                    img = np.clip(img, 0, 255).astype(np.uint8)
                else:
                    raise ValueError("body needs 'image' or 'image_b64'")
                probs = server.classify.submit(img)
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            except (RuntimeError, TimeoutError) as e:
                self._json(500, {"error": str(e)})
                return
            topk = int(body.get("topk", 3))
            names = server.classify.predictor.class_names
            order = np.argsort(probs)[::-1][:max(1, topk)]
            self._json(200, {
                "topk": [{"label": names[i], "prob": float(probs[i])}
                         for i in order],
                "probs": {names[i]: float(probs[i])
                          for i in range(len(names))}})

    return Handler
