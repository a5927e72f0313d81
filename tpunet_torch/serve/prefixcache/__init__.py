"""Prefix KV cache of the serving engine (copies of
``tpunet/serve/prefixcache/keys.py`` and ``cache.py``):

- :mod:`keys` — the token-prefix digest convention shared with the
  router's affinity hashing;
- :mod:`cache` — the per-replica refcounted trie of pages living
  inside the engine's paged KV pool (pin on admission, unpin on
  release, LRU-evict under pool pressure);
- :mod:`store` — shared-filesystem spill/warm-start (``--prefix-store``)
  through the fsatomic first-writer-wins commit (a copy of
  ``tpunet/serve/prefixcache/store.py``).
"""

from tpunet_torch.serve.prefixcache.cache import PrefixCache, PrefixNode
from tpunet_torch.serve.prefixcache.keys import (ROOT, chain_digests,
                                                 token_prefix_digest)
from tpunet_torch.serve.prefixcache.store import (PrefixStore,
                                                  build_prefix_store)

__all__ = [
    "PrefixCache",
    "PrefixNode",
    "PrefixStore",
    "ROOT",
    "build_prefix_store",
    "chain_digests",
    "token_prefix_digest",
]
