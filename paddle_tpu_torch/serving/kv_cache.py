"""Paged KV cache: block-structured decode state.

Counterpart of ``paddle_tpu/serving/kv_cache.py`` (no prefix cache).
K/V live in one pool per layer,
``[num_pages, block_size, H, D]``, stacked ``[L, ...]``; each batch slot
owns a row of a block table ``[slots, MB]`` mapping logical block ``j``
to a physical page; unallocated entries point at the reserved scratch
page 0, which takes the writes of inactive slots and padded prefill
tails and is masked out of every read.

Under ``FLAGS_serve_kv_quant=int8`` (read once, when the cache is built)
the pools hold int8 with a per-(position, head) f32 absmax scale pool
``[L, P, bs, H]`` beside each (``write_pages_quant``), and decode
dequantizes them as it reads.

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
from ..core.flags import get_flag

__all__ = ["BlockAllocator", "PagedKVCache", "PagedCacheView",
           "PagedLayerCache", "write_pages", "gather_pages",
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

    def layer(self, i: int) -> "PagedLayerCache":
        """Layer ``i``'s slice (views, no copies)."""
        pick = lambda t: None if t is None else t[i]     # noqa: E731
        return PagedLayerCache(self.k[i], self.v[i], self.block_table,
                               pick(self.k_scale), pick(self.v_scale),
                               pick(self.lora_a), pick(self.lora_b),
                               self.lora_ids)


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
    ``[L, P, bs, H]``."""

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
