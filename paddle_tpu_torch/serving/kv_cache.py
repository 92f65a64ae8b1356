"""Paged KV cache: block-structured decode state.

Counterpart of ``paddle_tpu/serving/kv_cache.py``. K/V live in one pool
per layer, ``[num_pages, block_size, H, D]``, stacked ``[L, ...]``, in
the cache's dtype (float32 or bfloat16; a write casts to it); each
batch slot owns a row of a block table ``[slots, MB]`` mapping logical
block ``j`` to a physical page; unallocated entries point at the
reserved scratch page 0, which takes the writes of inactive slots and
padded prefill tails and is masked out of every read.

Under ``FLAGS_serve_kv_quant=int8`` (read once, when the cache is built)
the pools hold int8 with a per-(position, head) f32 absmax scale pool
``[L, P, bs, H]`` beside each (``write_pages_quant``), and every read
dequantizes them.

Pages are refcounted (:class:`BlockAllocator`): with a radix prefix
cache attached (``serving.prefix_cache``) a slot may map cached pages
copy-on-write at the head of its table (``alloc_slot(shared_pages=)``),
a finished slot donates its full pages to the tree
(``free_slot(donate_tokens=)``), allocation pressure evicts the tree
before any preemption (``_alloc``), and a speculative rollback drops a
slot's tail pages (``truncate_slot``).

A **context dispatch** (a chunked-prefill continuation, the tail after
a prefix hit, a speculative verify window: S > 1 rows starting at
``pos > 0``) runs with a view whose ``context`` field holds a
:class:`ContextIndex` (the JAX package's ``ContextPagedCacheView``):
each row's first ``pos + S`` positions gathered
into the right end of a ``[B, C]`` context (:func:`context_index`,
:func:`gather_context`) with a ``-1e30`` key bias on the left padding,
so causal attention aligned bottom-right lets query row ``i`` see
exactly the positions ``<= pos + i``.

Where the JAX engine donated the pools to each compiled step and got new
ones back, the port writes them in place (``write_pages``).

Tensor-parallel serving (``ServingConfig.mesh``): a cache built with a
``mesh`` holds this rank's heads only, ``[L, P, bs, H/mp, D]`` (and
``[L, P, bs, H/mp]`` scales), the block of ``distributed.spmd.
SERVE_KV_SPEC``; ``head_block`` records ``(first head, heads, all
heads)``. The block tables, the page allocator and
:func:`gather_context` do not change: a page holds every head, so the
ranks of an mp group allocate the same pages for the same requests.
"""

from __future__ import annotations

import collections
import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.flags import get_flag

__all__ = ["BlockAllocator", "PagedKVCache", "PagedCacheView",
           "PagedLayerCache", "ContextPagedCacheView",
           "ContextPagedLayerCache", "ContextIndex", "context_index",
           "gather_context", "gather_context_quant", "write_pages",
           "gather_pages",
           "write_pages_quant", "gather_pages_quant", "dequant_pages",
           "blocks_needed", "SCRATCH_PAGE"]

#: physical page 0 is never allocated: the shared scratch target for
#: writes from inactive slots and padded prefill tails
SCRATCH_PAGE = 0


def blocks_needed(num_tokens: int, block_size: int) -> int:
    return max(0, math.ceil(int(num_tokens) / int(block_size)))


class PagedCacheView(NamedTuple):
    """What ``GPTModel.forward`` receives as ``caches``: layer-stacked
    pools ``[L, P, bs, H, D]`` and the ``[B, MB]`` int32 block table.

    The trailing fields default to ``None``: ``k_scale``/``v_scale`` are
    the ``[L, P, bs, H]`` f32 scale pools of an int8 cache;
    ``lora_a``/``lora_b`` the stacked LoRA pools ``[L, A, r, E]`` /
    ``[L, A, r, O]`` and ``lora_ids`` the ``[B]`` int32 adapter row of
    each batch row (``serving.lora``)."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    lora_a: Optional[torch.Tensor] = None
    lora_b: Optional[torch.Tensor] = None
    lora_ids: Optional[torch.Tensor] = None

    #: the dispatch's :class:`ContextIndex`: set, it selects the
    #: **context prefill** attention path (an S > 1 chunk at per-row
    #: positions ``pos`` attends over every page-resident position
    #: ``< pos`` as well as causally over itself)
    context: Optional["ContextIndex"] = None

    def layer(self, i: int) -> "PagedLayerCache":
        """Layer ``i``'s slice (views, no copies)."""
        pick = lambda t: None if t is None else t[i]     # noqa: E731
        return PagedLayerCache(self.k[i], self.v[i], self.block_table,
                               pick(self.k_scale), pick(self.v_scale),
                               pick(self.lora_a), pick(self.lora_b),
                               self.lora_ids, self.context)


class PagedLayerCache(NamedTuple):
    """One layer's slice of the view (``[P, bs, H, D]`` pools,
    ``[P, bs, H]`` scales, ``[A, r, E]`` / ``[A, r, O]`` LoRA pools)."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    lora_a: Optional[torch.Tensor] = None
    lora_b: Optional[torch.Tensor] = None
    lora_ids: Optional[torch.Tensor] = None
    context: Optional["ContextIndex"] = None


#: the JAX package's names for a view and a layer slice that carry a
#: ``context`` (there marker subtypes; here the field alone selects the
#: path)
ContextPagedCacheView = PagedCacheView
ContextPagedLayerCache = PagedLayerCache


class ContextIndex(NamedTuple):
    """Where each column of a dispatch's right-aligned context comes
    from, the same for every layer: physical ``pages`` and ``offsets``
    ``[B, C]`` (int64) and the additive key ``bias`` ``[B, C]`` float32,
    ``-1e30`` on the left padding and 0 elsewhere."""

    pages: torch.Tensor
    offsets: torch.Tensor
    bias: torch.Tensor


def context_index(block_table: np.ndarray, pos: np.ndarray, S: int,
                  block_size: int, device: DeviceLike = None) \
        -> ContextIndex:
    """The :class:`ContextIndex` of an S-row dispatch at host positions
    ``pos [B]`` over host block tables ``[B, MB]``: row ``b``'s positions
    ``0 .. pos[b] + S - 1`` fill the right end of ``C`` columns, ``C =
    max(MB * bs, max(pos + S))``, so that causal attention aligned
    bottom-right (query row ``i`` sees columns ``<= C - S + i``) sees
    exactly positions ``<= pos[b] + i``, the JAX package's
    ``cols <= pos + i`` mask (``models/gpt.py::_ctx_mask``). Columns left
    of position 0 read the scratch page under a ``-1e30`` bias; positions
    past the table (only padded rows reach them) read the scratch page
    too."""
    table = np.asarray(block_table, np.int64)
    pos = np.asarray(pos, np.int64)
    B, MB = table.shape
    C = max(MB * block_size, int((pos + S).max()) if B else 0)
    j = np.arange(C)[None, :] - (C - S - pos)[:, None]        # [B, C]
    inside = (j >= 0) & (j < MB * block_size)
    jc = np.clip(j, 0, MB * block_size - 1)
    pages = np.where(inside, np.take_along_axis(table, jc // block_size,
                                                axis=1), SCRATCH_PAGE)
    offsets = np.where(inside, jc % block_size, 0)
    bias = np.where(j < 0, np.float32(-1e30), np.float32(0.0))
    dev = resolve_device(device)
    return ContextIndex(torch.from_numpy(pages).to(dev),
                        torch.from_numpy(offsets).to(dev),
                        torch.from_numpy(bias.astype(np.float32)).to(dev))


def gather_context(pages, ctx: ContextIndex):
    """Layer pool ``[P, bs, H, D]`` gathered into the right-aligned
    context ``[B, C, H, D]`` of ``ctx``."""
    return pages[ctx.pages, ctx.offsets]


def gather_context_quant(pages, scales, ctx: ContextIndex):
    """The int8 twin of :func:`gather_context`: pages and scales
    gathered, then dequantized into an f32 context, as
    ``gather_pages_quant`` does."""
    return dequant_pages(pages[ctx.pages, ctx.offsets],
                         scales[ctx.pages, ctx.offsets])


def _page_slots(pages, block_table, pos, S):
    """Physical page and offset ``[B, S]`` of logical positions
    ``pos[b] + 0..S-1``; positions past ``MB*bs`` go to scratch."""
    bs = pages.shape[1]
    mb = block_table.shape[1]
    idx = pos[:, None].long() + torch.arange(S, device=pos.device)[None, :]
    blk_logical = torch.clamp(idx // bs, max=mb - 1)
    blk = torch.gather(block_table.long(), 1, blk_logical)     # [B, S]
    blk = torch.where(idx >= bs * mb, SCRATCH_PAGE, blk)
    return blk, idx % bs


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
    blk, off = _page_slots(pages, block_table, pos, new.shape[1])
    pages[blk, off] = new.to(pages.dtype)
    return pages


def gather_pages(pages, block_table):
    """A slot-contiguous context ``[B, MB*bs, H, D]`` gathered out of
    the pool through the block table (the PagedAttention read)."""
    g = pages[block_table.long()]                  # [B, MB, bs, H, D]
    B, MB, bs, H, D = g.shape
    return g.reshape(B, MB * bs, H, D)


#: int8 range: symmetric -127..127, so negation keeps the scale exact
_QMAX = 127.0
#: absmax floor: an all-zero row quantizes with scale eps, not 0/0
_QEPS = 1e-8


def write_pages_quant(pages, scales, new, block_table, pos):
    """Quantizing scatter, IN PLACE: the indexing of :func:`write_pages`,
    with ``new`` ``[B, S, H, D]`` stored as int8 in ``pages`` and a
    per-(row, head) absmax scale in ``scales`` ``[P, bs, H]``. The JAX
    order of operations, so the result is bit-equal:
    ``max(absmax, eps) / 127``, then ``x / scale`` rounded half to even
    and clipped to -127..127. Returns ``(pages, scales)``."""
    blk, off = _page_slots(pages, block_table, pos, new.shape[1])
    newf = new.float()
    scale = torch.clamp(newf.abs().amax(dim=-1), min=_QEPS) / _QMAX
    q = torch.clamp(torch.round(newf / scale[..., None]), -_QMAX, _QMAX)
    pages[blk, off] = q.to(torch.int8)
    scales[blk, off] = scale.to(scales.dtype)
    return pages, scales


def dequant_pages(pages, scales):
    """An int8 pool (or any gathered slice of one) back in f32:
    ``pages [..., H, D] * scales [..., H, None]``."""
    return pages.float() * scales.float()[..., None]


def gather_pages_quant(pages, scales, block_table):
    """The quantized PagedAttention read: int8 pages and their scales
    gathered through the block table and dequantized into a
    slot-contiguous f32 context ``[B, MB*bs, H, D]``."""
    t = block_table.long()
    g = dequant_pages(pages[t], scales[t])         # [B, MB, bs, H, D]
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
    tables are snapshot per dispatch by :meth:`table_array`. ``quant``
    is ``FLAGS_serve_kv_quant`` as it stood at construction: ``""``
    gives ``dtype`` pools and ``k_scale``/``v_scale`` None, ``"int8"``
    gives int8 pools ``[L, P, bs, H, D]`` and f32 scale pools
    ``[L, P, bs, H]``. With a ``mesh`` the pools hold this rank's
    ``H/mp`` heads (``spmd.shard_serving_cache``'s layout, built at that
    size); ``num_heads`` is then the rank's count and ``head_block``
    ``(first head, heads, all heads)``, None for a whole cache."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 *, num_pages: int, block_size: int, max_slots: int,
                 max_blocks_per_slot: int, dtype=torch.float32,
                 device: DeviceLike = None, mesh=None):
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.head_block = None
        if mesh is not None:
            from ..distributed.spmd import serving_heads
            h0, n = serving_heads(num_heads, mesh)
            self.head_block = (h0, n, int(num_heads))
            num_heads = n
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.dtype = dtype
        self.quant = str(get_flag("serve_kv_quant") or "")
        if self.quant not in ("", "int8"):
            raise ValueError(
                f"FLAGS_serve_kv_quant={self.quant!r}: supported modes "
                "are '' (full precision) and 'int8'")
        shape = (num_layers, num_pages, block_size, num_heads, head_dim)
        pool = torch.int8 if self.quant else dtype
        self.k = torch.zeros(shape, dtype=pool, device=self.device)
        self.v = torch.zeros(shape, dtype=pool, device=self.device)
        self.k_scale = self.v_scale = None
        if self.quant:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        self.allocator = BlockAllocator(num_pages)
        self._tables = np.full((max_slots, max_blocks_per_slot),
                               SCRATCH_PAGE, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        #: leading pages of each slot mapped copy-on-write from the
        #: prefix cache (never written by this slot: every write lands
        #: at positions >= shared * block_size)
        self._slot_shared: List[int] = [0] * max_slots
        #: optional serving.prefix_cache.RadixPrefixCache: evicted from
        #: when the free list cannot cover an allocation, and fed the
        #: pages free_slot donates
        self.prefix_cache = None

    def kv_bytes_per_token(self) -> int:
        """Device bytes one token position costs over all layers: int8
        pays ``H*D`` payload and ``H`` f32 scales a pool, full precision
        ``H*D*itemsize``."""
        H, D, L = self.num_heads, self.head_dim, self.num_layers
        if self.quant == "int8":
            per_pool = H * D + H * 4
        else:
            per_pool = H * D * self.dtype.itemsize
        return 2 * L * per_pool

    def table_rows(self, rows: Optional[Sequence[Optional[int]]] = None) \
            -> np.ndarray:
        """Host block tables: all slots, or one row per entry of
        ``rows`` — a ``None`` entry (a padded prefill row) gets an
        all-scratch row."""
        if rows is None:
            return self._tables.copy()
        t = np.full((len(rows), self.max_blocks_per_slot), SCRATCH_PAGE,
                    np.int32)
        for i, s in enumerate(rows):
            if s is not None:
                t[i] = self._tables[s]
        return t

    def table_array(self, rows: Optional[Sequence[Optional[int]]] = None):
        """:meth:`table_rows` as the dispatch's int32 device argument."""
        return torch.from_numpy(self.table_rows(rows)).to(self.device)

    @property
    def max_context_len(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    def slot_blocks(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def slot_shared_blocks(self, slot: int) -> int:
        """Leading copy-on-write pages mapped from the prefix cache
        (writes to this slot start at or after ``shared * block_size``)."""
        return self._slot_shared[slot]

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocator alloc with prefix-cache relief: when the free list
        cannot cover ``n``, evict LRU radix-tree pages until it can (or
        the tree runs out). Cached prefixes leave before any
        recompute-preemption fires."""
        pages = self.allocator.alloc(n)
        while pages is None and self.prefix_cache is not None:
            if self.prefix_cache.evict_for(
                    n - self.allocator.free_pages) <= 0:
                break
            pages = self.allocator.alloc(n)
        return pages

    def alloc_slot(self, slot: int, num_tokens: int,
                   shared_pages: Sequence[int] = ()) -> bool:
        """Allocate blocks covering ``num_tokens`` positions for a fresh
        slot. ``shared_pages`` are prefix-cache hits (already incref'd
        by the match) mapped read-only at the head of the table; only
        the remainder is allocated. False when the pool cannot cover the
        remainder, with the shared references dropped again, so a
        failed admission leaks nothing."""
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot} already holds pages; "
                               "free_slot first")
        shared = list(shared_pages)
        need = blocks_needed(num_tokens, self.block_size)
        if len(shared) > need:
            raise ValueError(
                f"slot {slot}: {len(shared)} shared pages exceed the "
                f"{need} blocks {num_tokens} tokens need")
        pages = self._alloc(need - len(shared))
        if pages is None:
            if shared:
                self.allocator.free(shared)
            return False
        self._slot_pages[slot] = shared + pages
        self._slot_shared[slot] = len(shared)
        self._tables[slot, :need] = self._slot_pages[slot]
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
        pages = self._alloc(need - have)
        if pages is None:
            return False
        self._slot_pages[slot].extend(pages)
        self._tables[slot, have:need] = pages
        return True

    def truncate_slot(self, slot: int, num_tokens: int) -> int:
        """Shrink the slot to cover only ``num_tokens`` positions (the
        speculative rollback): pages holding only rejected draft K/V
        leave the table and drop their reference. Never cuts into the
        shared prefix. Returns the number of pages released."""
        keep = blocks_needed(num_tokens, self.block_size)
        pages = self._slot_pages[slot]
        if keep >= len(pages):
            return 0
        if keep < self._slot_shared[slot]:
            raise ValueError(
                f"slot {slot}: truncation to {num_tokens} tokens would "
                f"cut into the {self._slot_shared[slot]} shared prefix "
                "pages")
        tail = pages[keep:]
        self.allocator.free(tail)
        self._slot_pages[slot] = pages[:keep]
        self._tables[slot, keep:] = SCRATCH_PAGE
        return len(tail)

    def free_slot(self, slot: int,
                  donate_tokens: Optional[Sequence[int]] = None) -> None:
        """Release the slot's pages (one reference each). With a prefix
        cache attached and ``donate_tokens`` (the token ids whose K/V
        the pages validly hold, in order), full pages are donated to the
        radix tree instead: the slot's reference passes to the tree, and
        a duplicate of a cached path is dropped."""
        pages = self._slot_pages[slot]
        if pages:
            donated = 0
            if self.prefix_cache is not None and donate_tokens is not None:
                donated = self.prefix_cache.donate(donate_tokens, pages)
            if donated < len(pages):
                self.allocator.free(pages[donated:])
        self._slot_pages[slot] = []
        self._slot_shared[slot] = 0
        self._tables[slot, :] = SCRATCH_PAGE
