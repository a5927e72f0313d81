"""Per-replica prefix KV cache: refcounted, content-addressed pages
inside the engine's shared page pool.

A copy of ``tpunet/serve/prefixcache/cache.py`` (host bookkeeping
only).

The cache does NOT own device memory — every cached page lives in the
same per-layer flat pool the engine's slots allocate from (page 0
stays the reserved garbage page). What the cache owns is the HOST
bookkeeping that lets finished prefills outlive their slot:

- a trie of :class:`PrefixNode`, one node per cached full page,
  keyed by the digest of the token prefix THROUGH that page
  (``keys.token_prefix_digest(tokens, (depth+1)*page_tokens)``) — so
  two prompts sharing the first k pages share the first k nodes;
- a refcount per node (slots currently mapping the page into their
  page table) — pinned pages are immutable and never freed;
- an LRU over EVICTABLE nodes: ``refs == 0`` and no children.
  Leaf-first eviction keeps every cached chain prefix-closed, which
  is what makes lookup's "walk down while present" correct.

Threading: all mutation happens on the engine thread (the same
discipline as the page allocator); no locks here.

Safety argument for sharing (docs/serving.md "Prefix KV cache"): the
paged attend write path scatters at ``positions >= start`` only, and
a slot that pinned k pages prefills with ``positions = k*page_tokens``
— pinned pages are never written by construction, so a cached page's
K/V rows are bitwise-frozen from insert to eviction. The recycling
stress test extends the zero-stale-bleed proof to this regime.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from tpunet_torch.serve.prefixcache import keys


class PrefixNode:
    """One cached full page of prefill K/V.

    ``depth`` d covers tokens ``[d*page_tokens, (d+1)*page_tokens)``;
    ``digest`` is the flat digest of the token prefix through the end
    of this page; ``parent`` is the depth d-1 node (None at depth 0).
    ``page`` is the pool page index holding the rows. ``refs`` counts
    slots whose page table currently maps this page. ``tick`` is the
    cache's logical clock at last touch (LRU order).
    """

    __slots__ = ("digest", "parent", "children", "page", "refs",
                 "tick", "depth")

    def __init__(self, digest: str, parent: Optional["PrefixNode"],
                 depth: int, page: int):
        self.digest = digest
        self.parent = parent
        self.children: set = set()
        self.page = page
        self.refs = 0
        self.tick = 0
        self.depth = depth


class PrefixCache:
    """Bounded trie of refcounted prefix pages (host side only).

    ``capacity`` bounds how many pool pages the cache may hold at
    refs == 0 + refs > 0 combined — the engine sizes it below the
    pool so paying slots always have headroom, and calls
    :meth:`evict_one` under pool pressure before failing an
    allocation.
    """

    def __init__(self, page_tokens: int, capacity: int, *,
                 registry=None):
        self.page_tokens = int(page_tokens)
        self.capacity = int(capacity)
        self._nodes: Dict[str, PrefixNode] = {}
        self._tick = 0
        self._reg = registry
        if registry is not None:
            self._c_lookups = registry.counter("serve_prefix_lookups_total")
            self._c_hits = registry.counter("serve_prefix_hits_total")
            self._c_hit_tokens = registry.counter(
                "serve_prefix_hit_tokens_total")
            self._c_inserts = registry.counter("serve_prefix_inserts_total")
            self._c_evictions = registry.counter(
                "serve_prefix_evictions_total")
            self._g_pages = registry.gauge("serve_prefix_pages_cached")
        else:
            self._c_lookups = self._c_hits = self._c_hit_tokens = None
            self._c_inserts = self._c_evictions = self._g_pages = None

    # -- introspection ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def pages_cached(self) -> int:
        return len(self._nodes)

    def pinned_pages(self) -> int:
        return sum(1 for n in self._nodes.values() if n.refs > 0)

    def evictable_pages(self) -> int:
        return sum(1 for n in self._nodes.values()
                   if n.refs == 0 and not n.children)

    def get(self, digest: str) -> Optional[PrefixNode]:
        return self._nodes.get(digest)

    # -- lookup / pin ----------------------------------------------------

    def lookup(self, tokens: Sequence[int],
               max_pages: int) -> List[PrefixNode]:
        """The longest cached chain covering the first full pages of
        ``tokens``, capped at ``max_pages`` — counted as one lookup
        (and one hit when non-empty). Does NOT pin; the engine pins
        only once the slot's remaining allocation succeeded."""
        chain: List[PrefixNode] = []
        pt = self.page_tokens
        for d in range(max_pages):
            node = self._nodes.get(
                keys.token_prefix_digest(tokens, (d + 1) * pt))
            if node is None:
                break
            chain.append(node)
        if self._c_lookups is not None:
            self._c_lookups.inc()
            if chain:
                self._c_hits.inc()
                self._c_hit_tokens.inc(len(chain) * pt)
        return chain

    def pin(self, nodes: Sequence[PrefixNode]) -> None:
        """refcount++ each node (slot admission mapped its page)."""
        self._tick += 1
        for n in nodes:
            n.refs += 1
            n.tick = self._tick

    def unpin(self, nodes: Sequence[PrefixNode]) -> None:
        """refcount-- each node (slot released its page table). The
        page stays cached — eviction, not release, returns it to the
        free list."""
        self._tick += 1
        for n in nodes:
            n.refs -= 1
            assert n.refs >= 0, "prefix page unpinned below zero"
            n.tick = self._tick

    # -- insert / evict --------------------------------------------------

    def insert(self, digest: str, parent: Optional[PrefixNode],
               depth: int, page: int) -> PrefixNode:
        """Adopt ``page`` (already holding the rows for this chain
        position) as a cached node. The caller has already checked
        ``get(digest) is None`` — concurrent-duplicate dedup is the
        engine's job because the duplicate page must go back to the
        pool. The node is returned UNPINNED; the caller pins it if a
        slot still maps it."""
        assert digest not in self._nodes
        node = PrefixNode(digest, parent, depth, page)
        if parent is not None:
            parent.children.add(node)
        self._tick += 1
        node.tick = self._tick
        self._nodes[digest] = node
        if self._c_inserts is not None:
            self._c_inserts.inc()
            self._g_pages.set(len(self._nodes))
        return node

    def evict_one(self) -> Optional[int]:
        """Drop the least-recently-touched evictable node (refs == 0,
        no children) and return its pool page for the free list; None
        when nothing is evictable (every cached page is pinned by a
        live slot or interior to a pinned chain)."""
        victim: Optional[PrefixNode] = None
        for n in self._nodes.values():
            if n.refs == 0 and not n.children:
                if victim is None or n.tick < victim.tick:
                    victim = n
        if victim is None:
            return None
        del self._nodes[victim.digest]
        if victim.parent is not None:
            victim.parent.children.discard(victim)
        if self._c_evictions is not None:
            self._c_evictions.inc()
            self._g_pages.set(len(self._nodes))
        return victim.page
