"""Content addresses for prefix KV pages.

A copy of ``tpunet/serve/prefixcache/keys.py``: the digest convention
is shared with the JAX package's router affinity hash.

ONE digest convention shared by the three parties that must agree on
what "the same prefix" means (docs/serving.md "Prefix KV cache"):

- the router's rendezvous affinity key (``tpunet.router.balance``
  hashes ``token_prefix_digest`` so shared-prefix traffic lands on
  the replica already holding those pages),
- the per-replica in-pool cache (``PrefixCache`` keys each cached
  page by the digest of the token prefix THROUGH that page),
- the shared-filesystem spill store (``PrefixStore`` names entries
  ``<store_digest>-<chain_digest>`` so a respawned replica loads
  exactly the prefixes the fleet's routers are steering at it).

The digest is FLAT, not incremental: sha256 over the little-endian
int32 bytes of ``tokens[:n]``. A chained/rolling form would be
cheaper per page but couples every consumer to the chaining order;
prompts are short enough that re-hashing the prefix per page boundary
is noise next to the prefill it replaces.

Config partitioning (model fingerprint, kv levers, jax version,
device kind) is deliberately NOT folded in here — the in-pool cache
lives inside one engine so every entry trivially shares its config,
and the spill store scopes files by its own ``store_digest`` prefix.
Keeping token digests config-free is what lets the router (which
knows nothing about model configs) hash the same bytes.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

#: Parent key of a depth-0 cache node (no token prefix above it).
ROOT = "root"


def token_prefix_digest(tokens: Sequence[int], n: int) -> str:
    """Stable 16-hex digest of ``tokens[:n]`` (little-endian int32
    bytes — the dtype prompts are staged in on the host)."""
    h = hashlib.sha256()
    for t in tokens[:n]:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return h.hexdigest()[:16]


def chain_digests(tokens: Sequence[int], page_tokens: int,
                  pages: int) -> list:
    """Digest of the token prefix through each of the first ``pages``
    full pages: element ``d`` keys the page covering tokens
    ``[d*page_tokens, (d+1)*page_tokens)``."""
    return [token_prefix_digest(tokens, (d + 1) * page_tokens)
            for d in range(pages)]
