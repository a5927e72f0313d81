"""Prefix KV cache of the serving engine (copies of
``tpunet/serve/prefixcache/keys.py`` and ``cache.py``):

- :mod:`keys` — the token-prefix digest convention shared with the
  router's affinity hashing;
- :mod:`cache` — the per-replica refcounted trie of pages living
  inside the engine's paged KV pool (pin on admission, unpin on
  release, LRU-evict under pool pressure).

The shared-filesystem spill store (``--prefix-store``) is ROADMAP Queue
A item 5.
"""

from tpunet_torch.serve.prefixcache.cache import PrefixCache, PrefixNode
from tpunet_torch.serve.prefixcache.keys import (ROOT, chain_digests,
                                                 token_prefix_digest)

__all__ = [
    "PrefixCache",
    "PrefixNode",
    "ROOT",
    "chain_digests",
    "token_prefix_digest",
]
