"""Bounded in-memory journal of in-flight streamed requests.

A copy of ``tpunet/router/journal.py`` (stdlib only).

The enabling bookkeeping for mid-stream failover (docs/serving.md
"Mid-stream failover & serve-tier chaos"): for every streaming
``/v1/generate`` the frontend relays, the journal keeps the original
request body (prompt, sampling params, seed, budget) plus every token
id already relayed to the client. When the serving replica dies after
first bytes reached the client, that journal IS the resume state —
the frontend re-submits to a survivor with ``resume_tokens`` and the
client's ndjson stream continues where it stopped.

Bounds: one entry per in-flight stream, freed on finish (client done,
client gone, or abandonment); a stream that relays more than
``max_tokens`` tokens keeps streaming but loses failover protection
(``over_cap`` — on replica death it gets the honest error frame, the
documented degradation mode). Memory is therefore O(in-flight streams
x max_tokens), never O(history).

``active_failovers()`` feeds the drain path: a router drain waits for
in-flight failovers against the shared grace budget instead of
orphaning a journaled request with its frontend thread.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

_ids = itertools.count(1)


class JournalEntry:
    """One in-flight streamed request's resume state. Mutated only by
    its owning frontend handler thread; read by the drain path."""

    __slots__ = ("id", "body", "tokens", "over_cap", "failover_count",
                 "deadline_t", "failing_over", "trace_id",
                 "trace_sampled", "hop", "tokens_relayed")

    def __init__(self, body: dict,
                 deadline_t: Optional[float] = None):
        self.id = next(_ids)
        # The resubmittable request: everything the client sent except
        # transport-level fields the relay re-derives.
        self.body = dict(body)
        self.tokens: List[int] = []
        self.over_cap = False
        self.failover_count = 0
        self.deadline_t = deadline_t
        self.failing_over = False
        # Trace context (tpunet_torch/obs/tracing.py): the id travels on
        # every hop's headers — including failover re-submits, which
        # is why it lives HERE next to the resume state. ``hop``
        # counts replica opens (0 = router itself; each open / re-open
        # increments), so (trace_id, hop) names one process span.
        self.trace_id = ""
        self.trace_sampled = False
        self.hop = 0
        # Journal length at the LAST failover seam — what the
        # ``obs_trace`` router record reports as ``tokens_relayed``
        # (None until a failover happens).
        self.tokens_relayed: Optional[int] = None

    def remaining_ms(self,
                     now: Optional[float] = None) -> Optional[float]:
        """Milliseconds left of the client's deadline budget (None =
        no deadline; <= 0 = expired)."""
        if self.deadline_t is None:
            return None
        return 1e3 * (self.deadline_t
                      - (time.monotonic() if now is None else now))

    def resume_body(self) -> dict:
        """The failover re-submission: the original body plus the
        journaled continuation point."""
        body = dict(self.body)
        body["resume_tokens"] = list(self.tokens)
        body["stream"] = True
        return body


class RequestJournal:
    """Registry of in-flight journal entries (one router-wide
    instance, owned by the Router so the drain path can see it)."""

    def __init__(self, max_tokens: int = 4096):
        if max_tokens < 1:
            raise ValueError(
                f"failover_journal_tokens must be >= 1, "
                f"got {max_tokens}")
        self.max_tokens = max_tokens
        self._lock = threading.Lock()
        self._entries: Dict[int, JournalEntry] = {}

    def open(self, body: dict,
             deadline_t: Optional[float] = None) -> JournalEntry:
        entry = JournalEntry(body, deadline_t)
        with self._lock:
            self._entries[entry.id] = entry
        return entry

    def close(self, entry: JournalEntry) -> None:
        """Free the entry (stream finished or abandoned). Idempotent."""
        with self._lock:
            self._entries.pop(entry.id, None)
            entry.failing_over = False

    def note_token(self, entry: JournalEntry, token: int) -> bool:
        """Record one relayed token. Returns False once the entry is
        over the cap (the token is NOT recorded; the stream keeps
        relaying but is no longer failover-protected)."""
        if entry.over_cap:
            return False
        if len(entry.tokens) >= self.max_tokens:
            entry.over_cap = True
            return False
        entry.tokens.append(int(token))
        return True

    def begin_failover(self, entry: JournalEntry) -> None:
        entry.failover_count += 1
        entry.failing_over = True
        entry.tokens_relayed = len(entry.tokens)

    def end_failover(self, entry: JournalEntry) -> None:
        entry.failing_over = False

    def active(self) -> int:
        with self._lock:
            return len(self._entries)

    def active_failovers(self) -> int:
        """In-flight requests currently between a replica death and
        their resumed stream's completion — what a drain must wait
        for before it tears the replica set down."""
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if e.failing_over)
