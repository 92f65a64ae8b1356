"""Paged KV cache: block-structured decode state.

Counterpart of ``paddle_tpu/serving/kv_cache.py`` (full-precision pools,
no prefix cache). K/V live in one pool per layer,
``[num_pages, block_size, H, D]``, stacked ``[L, ...]``; each batch slot
owns a row of a block table ``[slots, MB]`` mapping logical block ``j``
to a physical page; unallocated entries point at the reserved scratch
page 0, which takes the writes of inactive slots and padded prefill
tails and is masked out of every read.

Where the JAX engine donated the pools to each compiled step and got new
ones back, the port writes them in place (``write_pages``).
"""

from __future__ import annotations

import collections
import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

__all__ = ["BlockAllocator", "PagedKVCache", "PagedCacheView",
           "PagedLayerCache", "write_pages", "gather_pages",
           "blocks_needed", "SCRATCH_PAGE"]

#: physical page 0 is never allocated: the shared scratch target for
#: writes from inactive slots and padded prefill tails
SCRATCH_PAGE = 0


def blocks_needed(num_tokens: int, block_size: int) -> int:
    return max(0, math.ceil(int(num_tokens) / int(block_size)))


class PagedCacheView(NamedTuple):
    """What ``GPTModel.forward`` receives as ``caches``: layer-stacked
    pools ``[L, P, bs, H, D]`` and the ``[B, MB]`` int32 block table."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor


class PagedLayerCache(NamedTuple):
    """One layer's slice of the view (``[P, bs, H, D]`` pools)."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_table: torch.Tensor


def write_pages(pages, new, block_table, pos):
    """Scatter ``new`` ``[B, S, H, D]`` into ``pages`` ``[P, bs, H, D]``
    IN PLACE at logical positions ``pos[b] + 0..S-1`` through
    ``block_table`` ``[B, MB]``. Positions past ``MB*bs`` (padded prefill
    tails) route to the scratch page. Returns ``pages``.

    JAX clamps an out-of-range gather index silently; PyTorch does not,
    so the logical block is clamped explicitly (the clamped entries are
    the ones redirected to scratch). Several rows may write the scratch
    page at once; their order is undefined, as in JAX, and nothing reads
    those writes as live data."""
    bs = pages.shape[1]
    mb = block_table.shape[1]
    S = new.shape[1]
    idx = pos[:, None].long() + torch.arange(S, device=pos.device)[None, :]
    blk_logical = torch.clamp(idx // bs, max=mb - 1)
    blk = torch.gather(block_table.long(), 1, blk_logical)     # [B, S]
    blk = torch.where(idx >= bs * mb, SCRATCH_PAGE, blk)
    off = idx % bs
    pages[blk, off] = new.to(pages.dtype)
    return pages


def gather_pages(pages, block_table):
    """A slot-contiguous context ``[B, MB*bs, H, D]`` gathered out of
    the pool through the block table (the PagedAttention read)."""
    g = pages[block_table.long()]                  # [B, MB, bs, H, D]
    B, MB, bs, H, D = g.shape
    return g.reshape(B, MB * bs, H, D)


class BlockAllocator:
    """Host-side refcounted free list over the physical page pool (page
    0 reserved as scratch). Allocation is all-or-nothing, so a
    half-admitted request never wedges the pool; a page re-enters the
    free list when its last reference goes."""

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(
                f"page pool of {num_pages} leaves nothing to allocate "
                f"({reserved} reserved)")
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        self._free = collections.deque(range(reserved, num_pages))
        self._rc: dict = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.reserved - len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc.get(int(page), 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages at refcount 1, or None (and no change)."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def incref(self, page: int) -> None:
        page = int(page)
        if page not in self._rc:
            raise ValueError(f"incref on unallocated page {page}")
        self._rc[page] += 1

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            p = int(p)
            if not (self.reserved <= p < self.num_pages):
                raise ValueError(f"freeing page {p} outside the pool")
            rc = self._rc.get(p)
            if rc is None:
                raise ValueError(f"double free of page {p} "
                                 "(refcount already 0)")
            if rc > 1:
                self._rc[p] = rc - 1
            else:
                del self._rc[p]
                self._free.append(p)


class PagedKVCache:
    """Device page pools + host block tables for a fixed slot batch.

    The pools are written in place by the model's forward; the host
    tables are snapshot per dispatch by :meth:`table_array`."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 *, num_pages: int, block_size: int, max_slots: int,
                 max_blocks_per_slot: int, dtype=torch.float32,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.dtype = dtype
        shape = (num_layers, num_pages, block_size, num_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = BlockAllocator(num_pages)
        self._tables = np.full((max_slots, max_blocks_per_slot),
                               SCRATCH_PAGE, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]

    def table_array(self, rows: Optional[Sequence[Optional[int]]] = None):
        """Block tables as the dispatch's int32 argument: all slots, or
        one row per entry of ``rows`` — a ``None`` entry (a padded
        prefill row) gets an all-scratch row."""
        if rows is None:
            t = self._tables
        else:
            t = np.full((len(rows), self.max_blocks_per_slot),
                        SCRATCH_PAGE, np.int32)
            for i, s in enumerate(rows):
                if s is not None:
                    t[i] = self._tables[s]
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)

    @property
    def max_context_len(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    def alloc_slot(self, slot: int, num_tokens: int) -> bool:
        """Allocate blocks covering ``num_tokens`` positions for a fresh
        slot; False when the pool cannot cover them."""
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot} already holds pages; "
                               "free_slot first")
        need = blocks_needed(num_tokens, self.block_size)
        pages = self.allocator.alloc(need)
        if pages is None:
            return False
        self._slot_pages[slot] = pages
        self._tables[slot, :need] = pages
        return True

    def extend_slot(self, slot: int, num_tokens: int) -> bool:
        """Grow the slot to cover ``num_tokens`` positions; False when
        the pool is dry (the preemption trigger)."""
        need = blocks_needed(num_tokens, self.block_size)
        have = len(self._slot_pages[slot])
        if need <= have:
            return True
        if need > self.max_blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {num_tokens} tokens exceed the "
                f"{self.max_context_len}-token slot capacity")
        pages = self.allocator.alloc(need - have)
        if pages is None:
            return False
        self._slot_pages[slot].extend(pages)
        self._tables[slot, have:need] = pages
        return True

    def free_slot(self, slot: int) -> None:
        pages = self._slot_pages[slot]
        if pages:
            self.allocator.free(pages)
        self._slot_pages[slot] = []
        self._tables[slot, :] = SCRATCH_PAGE
