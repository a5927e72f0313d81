"""Replica selection: least-loaded with session/prefix affinity.

A copy of ``tpunet/router/balance.py``: the affinity keys are the JAX
package's byte for byte for the same body (the token digest is the
port's copy of ``token_prefix_digest``), so a mixed fleet routes
alike behind either package's router.

Least-loaded is the workhorse: route to the replica with the lowest
``(queue_depth + active_slots) / slots`` from the live probes. On top
of it, AFFINITY keeps shared-prefix traffic together: requests that
carry the same ``"session"`` field — or whose first
``affinity_prefix`` prompt tokens/bytes match — hash to a stable
preferred replica via rendezvous (highest-random-weight) hashing, so
a conversation (or a fleet of requests sharing a long system prompt)
keeps hitting the replica whose KV pages for that prefix are warm
instead of re-prefilling on a cold one. Affinity yields to load: when
the preferred replica's load score exceeds the least-loaded one's by
more than ``affinity_slack``, least-loaded wins (a hot session must
not melt one replica while others idle).

Rendezvous hashing (rather than a modulo ring) means an evicted or
added replica only moves the keys that hashed to it — every other
session keeps its warm replica through membership changes.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

from tpunet_torch.router.replica import ReplicaHandle


def affinity_key(body: dict, prefix: int) -> Optional[str]:
    """The affinity hash key for one /v1/generate body, or None when
    the request has nothing to be affine on. An explicit ``session``
    wins; otherwise the first ``prefix`` prompt units (tokens or
    UTF-8 bytes) identify the shared prefix.

    Token-prefix requests hash the SAME digest the replicas' prefix
    KV cache keys its pages on (tpunet_torch/serve/prefixcache/keys.py),
    so
    the digest the router routes by and the digest the cache hits on
    agree by construction: shared-prefix traffic lands where those
    exact pages are warm."""
    session = body.get("session")
    if session:
        return f"s:{session}"
    if prefix <= 0:
        return None
    tokens = body.get("tokens")
    if isinstance(tokens, list) and tokens:
        from tpunet_torch.serve.prefixcache.keys import \
            token_prefix_digest
        return "t:" + token_prefix_digest(tokens, prefix)
    prompt = body.get("prompt")
    if isinstance(prompt, str) and prompt:
        return "p:" + prompt.encode("utf-8")[:prefix].hex()
    return None


def _weight(key: str, name: str) -> int:
    """Deterministic rendezvous weight of (key, replica)."""
    digest = hashlib.sha256(f"{key}\x00{name}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def preferred_replica(replicas: List[ReplicaHandle],
                      key: str) -> Optional[ReplicaHandle]:
    """Highest-random-weight member for ``key`` among the given
    (already-filtered) replicas."""
    if not replicas:
        return None
    return max(replicas, key=lambda r: _weight(key, r.name))


def pick_replica(replicas: List[ReplicaHandle],
                 key: Optional[str] = None, *,
                 affinity_slack: float = 0.5,
                 exclude=()):
    """Pick the target replica for one request. Returns
    ``(replica, affinity_hit)`` — replica is None when nothing is
    routable (the frontend answers 503 + Retry-After), affinity_hit
    is True when the pick followed the affinity hash rather than pure
    least-loaded.

    ``exclude`` carries the replica names already tried by this
    request's re-route loop."""
    candidates = [r for r in replicas
                  if r.routable() and r.name not in exclude]
    if not candidates:
        return None, False
    least = min(candidates,
                key=lambda r: (r.load_score(), r.requests_routed,
                               r.name))
    if key is None:
        return least, False
    preferred = preferred_replica(candidates, key)
    if preferred is least:
        return least, True
    pref_load = preferred.load_score()
    if pref_load != float("inf") \
            and pref_load <= least.load_score() + affinity_slack:
        return preferred, True
    return least, False
