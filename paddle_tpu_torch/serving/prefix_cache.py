"""Radix-tree prefix cache over the paged KV pools.

Counterpart of ``paddle_tpu/serving/prefix_cache.py`` (pure Python, so
the port keeps its own copy): the SGLang RadixAttention idea on the
page pools. K/V a finished request computed for its prompt is a
reusable artifact: chat traffic re-sends the same system prompt, and
every byte of that prefix's K/V is identical across requests. Donated
pages live in a token-keyed radix tree at PAGE granularity:

- every edge of the tree is one FULL page, keyed by the exact
  ``block_size``-token tuple it holds, so a cached page maps into a new
  slot's block table as-is (one int), no copy, no kernel change;
- **donation** (``free_slot(donate_tokens=...)``): when a request
  terminates or is preempted, its full pages walk into the tree —
  ownership of the slot's page reference transfers to the tree, paths
  already cached drop the duplicate;
- **match** (admission): the new request's effective prompt walks the
  tree; every hit page is ``incref``'d and mapped **copy-on-write**
  into the slot's table head (the slot never writes positions below
  the shared coverage — prefill starts at the hit length), and the
  engine prefills ONLY the tail. A partial-page tail is re-prefilled;
- **eviction**: LRU over leaf pages, triggered by allocation pressure
  (``PagedKVCache._alloc``) BEFORE any recompute-preemption — a cached
  prefix is cheaper to lose than a live request's progress. Eviction
  drops the tree's reference; a page still mapped by live slots stays
  allocated until they finish (the refcount contract).

The match result is always capped one token short of the query: the
engine must prefill at least the LAST prompt token to have a logits
row to sample the first output token from.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RadixPrefixCache"]


class _Node:
    """One cached page: the edge from ``parent`` keyed by the
    ``block_size``-token tuple whose K/V the page holds."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = int(page)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class RadixPrefixCache:
    """Token-keyed radix tree of donated KV pages with LRU eviction.

    Owns ONE allocator reference per resident page; slots that map a
    cached page hold their own references on top (``incref`` at match
    time), so eviction and slot lifetime compose without coordination.
    Host-side stats accumulate in ``self.stats``.
    """

    def __init__(self, cache):
        self.cache = cache                    # PagedKVCache
        self.block_size = int(cache.block_size)
        self._root = _Node((), -1, None)
        self._nodes: Dict[int, _Node] = {}    # page -> node
        self._tick = 0
        self.stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                      "hit_pages": 0, "donated_pages": 0,
                      "evicted_pages": 0, "lookups": 0}

    # -- introspection -------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- admission-side ------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of ``tokens`` →
        ``(n_tokens, pages)``. Every returned page is ``incref``'d for
        the caller (the slot mapping it); the hit is capped at
        ``len(tokens) - 1`` so at least one token remains to prefill.
        An empty result means a full cold prefill."""
        bs = self.block_size
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        max_blocks = max(0, (len(toks) - 1) // bs)
        node = self._root
        pages: List[int] = []
        for i in range(max_blocks):
            child = node.children.get(tuple(toks[i * bs:(i + 1) * bs]))
            if child is None:
                break
            self._touch(child)
            pages.append(child.page)
            node = child
        self.stats["lookups"] += 1
        if pages:
            for p in pages:
                self.cache.allocator.incref(p)
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(pages) * bs
            self.stats["hit_pages"] += len(pages)
        else:
            self.stats["misses"] += 1
        return len(pages) * bs, pages

    # -- donation ------------------------------------------------------------
    def donate(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Walk ``tokens``' full pages into the tree, CONSUMING the
        caller's reference on each consumed page (kept for a new node,
        dropped for a path already cached). Returns how many leading
        entries of ``pages`` were consumed — the caller frees the rest
        (the partial tail and anything beyond the valid token count)."""
        bs = self.block_size
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        full = min(len(toks) // bs, len(pages))
        node = self._root
        for i in range(full):
            key = tuple(toks[i * bs:(i + 1) * bs])
            page = int(pages[i])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page, node)
                node.children[key] = child
                self._nodes[page] = child
                self.stats["donated_pages"] += 1
            else:
                # the path is already cached under a (possibly
                # different) physical page — drop the duplicate ref
                self.cache.allocator.free([page])
            self._touch(child)
            node = child
        return full

    # -- eviction ------------------------------------------------------------
    def evict_for(self, n_pages: int) -> int:
        """Drop LRU leaf pages until at least ``n_pages`` re-entered
        the allocator free list or the tree is empty. Returns the pages
        actually RETURNED to the free list (a page still mapped by a
        live slot leaves the tree but stays allocated — it contributes
        0 here and frees when its slots do).

        One leaf heap is built per call and parents join it as their
        last child leaves — O((leaves + evicted)·log n), so an eviction
        storm inside the admission path never rescans the whole tree
        per page. Nothing touches ``last_used`` mid-call (the serving
        loop is single-threaded), so the snapshot order stays valid."""
        import heapq
        freed = 0
        alloc = self.cache.allocator
        heap = [(node.last_used, node.page)
                for node in self._nodes.values() if not node.children]
        heapq.heapify(heap)
        while heap and freed < max(n_pages, 1):
            _, page = heapq.heappop(heap)
            leaf = self._nodes.get(page)
            if leaf is None or leaf.children:
                continue
            del self._nodes[page]
            parent = leaf.parent
            del parent.children[leaf.key]
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last_used, parent.page))
            before = alloc.free_pages
            alloc.free([page])
            freed += alloc.free_pages - before
            self.stats["evicted_pages"] += 1
        return freed

    def clear(self) -> int:
        """Drop every cached page (engine shutdown). Returns the count
        dropped."""
        n = len(self._nodes)
        for node in list(self._nodes.values()):
            self.cache.allocator.free([node.page])
        self._nodes.clear()
        self._root.children.clear()
        return n
