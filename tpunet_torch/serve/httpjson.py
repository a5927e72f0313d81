"""Shared JSON helpers for the stdlib HTTP handlers.

A copy of ``tpunet/serve/httpjson.py`` (stdlib only): the port's
server answers in the JAX package's wire shapes.

The serve frontend and the router frontend speak the same wire shapes
(JSON bodies in, JSON + optional extra headers out); keeping the two
implementations in one place means a fix to either — charset, error
payload shape, a Content-Length edge case — cannot silently miss the
other surface.
"""

from __future__ import annotations

import json
from typing import Iterable, Tuple

Headers = Iterable[Tuple[str, str]]


def write_json(handler, code: int, obj: dict,
               headers: Headers = ()) -> None:
    """Send one JSON response (Content-Length framed) with optional
    extra headers (e.g. Retry-After on 503s)."""
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for name, value in headers:
        handler.send_header(name, value)
    handler.end_headers()
    handler.wfile.write(body)


def read_json_body(handler) -> dict:
    """Read and parse the request body; raises ValueError on invalid
    JSON or a non-object top level (callers map it to 400)."""
    n = int(handler.headers.get("Content-Length") or 0)
    if n <= 0:
        return {}
    raw = handler.rfile.read(n)
    try:
        obj = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"invalid JSON body: {e}")
    if not isinstance(obj, dict):
        raise ValueError("body must be a JSON object")
    return obj
