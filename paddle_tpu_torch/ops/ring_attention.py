"""Sequence parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``paddle_tpu/ops/ring_attention.py`` (``block_attention``,
``_merge``, ``ring_attention``, ``ulysses_attention``). The JAX
functions run inside ``shard_map`` over the mesh's ``sp`` axis and
``jax.grad`` differentiates through them; here a rank is a process, the
functions take its shard ``[B, S/sp, H, D]`` and the sp process group,
and each is a ``torch.autograd.Function`` with its own backward.

- :func:`ring_attention`: Q stays; the K/V block rotates around the
  group (``collective.ppermute_shift``, rank ``r``'s block to ``r + 1``)
  and each visited block's ``(o, lse)`` is merged into an f32
  accumulator with the JAX log-sum-exp combine (:func:`merge`). Causal:
  blocks from earlier ranks attend in full, the home block causally at
  ``Sq = Sk``, later blocks are skipped (no launch). Every block goes
  through the flash forward kernel (``return_lse=True``; row 1 of the
  kernel table on the card). The backward does not differentiate
  through the merge (the kernel takes no lse gradient): it rotates K/V
  again and runs the flash backward (row 3) on each visited block with
  the MERGED ``o`` and ``lse``, which gives each block's exact share of
  dq, dk and dv; dq sums locally and each block's dk/dv travel with it
  in an f32 accumulator and take one last hop back to its home rank.
- :func:`ulysses_attention`: all-to-all from sequence to heads (each
  rank then holds the whole sequence on ``H/sp`` heads), the flash
  kernels on those heads, all-to-all back; the backward is the same
  three steps reversed. Needs ``H % sp == 0``.

Dropout draws the single-process masks: the kernels hash each element's
absolute (batch, head, query row, key column), a ring block passing its
first query row (``rank * S/sp``) and its first key column (the block's
home rank's) as the kernels' row and column bases, Ulysses its first
head. On one card the group is gloo and each hop goes through pinned
host buffers (``collective.p2p_route``): :data:`RING_STATS` counts the
hops and the host seconds inside them.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import torch

from .attention import NEG_INF
from .kernels.flash_attention import (_aligned, flash_attention,
                                      flash_attention_bwd,
                                      flash_attention_fwd)

__all__ = ["ring_attention", "ulysses_attention", "block_attention",
           "merge", "RING_STATS", "reset_ring_stats"]

#: K/V (and dK/dV) hops of ring attention and the host seconds inside
#: them, Ulysses all-to-alls and theirs, since the last reset
RING_STATS = {"hops": 0, "hop_s": 0.0, "alltoalls": 0, "alltoall_s": 0.0}


def reset_ring_stats() -> None:
    RING_STATS.update(hops=0, hop_s=0.0, alltoalls=0, alltoall_s=0.0)


def _lone(group) -> bool:
    return group is None or group.nranks <= 1


def block_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    seed_words=None, batch_base: int = 0, head_base: int = 0,
                    row_base: int = 0, col_base: int = 0):
    """Attention of ``q [B, Sq, H, D]`` over one K/V block, returning
    ``(o, lse)`` with ``lse [B, Sq, H]`` float32 for :func:`merge` (the
    JAX layout); the flash forward kernel on the card. The bases place
    the block's rows and columns in the whole attention for the dropout
    mask."""
    o, lse = flash_attention_fwd(q, k, v, causal, scale, True,
                                 dropout_rate, seed_words, batch_base,
                                 head_base, row_base, col_base)
    return o, lse.transpose(1, 2)


def merge(o_a, lse_a, o_b, lse_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine two attention partials over disjoint key sets (the JAX
    ``_merge``): ``o [B, S, H, D]``, ``lse [B, S, H]``; the result in
    float32 (the accumulator stays f32 across ring steps)."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(m <= NEG_INF, 0.0, m)
    wa = torch.exp(lse_a - m_safe)
    wb = torch.exp(lse_b - m_safe)
    denom = wa + wb
    denom = torch.where(denom == 0.0, 1.0, denom)
    o = (o_a.float() * (wa / denom)[..., None]
         + o_b.float() * (wb / denom)[..., None])
    lse = torch.where(m <= NEG_INF, NEG_INF, m + torch.log(denom))
    return o, lse


def _hop(x, group):
    """Rank r's tensor to rank r + 1 of ``group``; returns what arrived."""
    from ..distributed.collective import ppermute_shift
    t0 = time.perf_counter()
    out = ppermute_shift(x, group, 1)
    RING_STATS["hops"] += 1
    RING_STATS["hop_s"] += time.perf_counter() - t0
    return out


def _blocks(group, causal: bool):
    """``(step, src)`` of every ring step, with whether this rank
    attends to the block from ``src`` (causal: not to later ranks')."""
    n, me = group.nranks, group.rank
    for t in range(n):
        src = (me - t) % n
        yield t, src, not (causal and src > me)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, rate, words, b0, h0):
        q, k, v = (_aligned(t) for t in (q, k, v))
        S, me = q.shape[1], group.rank
        kv = torch.stack([k, v])
        o_acc = lse_acc = None
        for t, src, visit in _blocks(group, causal):
            if t:
                kv = _hop(kv, group)
            if not visit:
                continue
            o_i, lse_i = block_attention(
                q, kv[0], kv[1], causal and src == me, scale, rate, words,
                b0, h0, me * S, src * S)
            if o_acc is None:
                o_acc, lse_acc = o_i.float(), lse_i
            else:
                o_acc, lse_acc = merge(o_acc, lse_acc, o_i, lse_i)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse_acc.transpose(1, 2)
                              .contiguous())
        ctx.args = (group, causal, scale, rate, words, b0, h0)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale, rate, words, b0, h0 = ctx.args
        do = _aligned(do)
        S, me = q.shape[1], group.rank
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for t, src, visit in _blocks(group, causal):
            if t:
                kv, dkv = _hop(kv, group), _hop(dkv, group)
            if not visit:
                continue
            dq_i, dk_i, dv_i = flash_attention_bwd(
                q, kv[0], kv[1], o, lse, do, causal and src == me, scale,
                rate, words, b0, h0, me * S, src * S)
            dq += dq_i.float()
            dkv[0] += dk_i.float()
            dkv[1] += dv_i.float()
        # the last block held came from rank me + 1: one more hop home
        dkv = _hop(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None, None, None)


def ring_attention(q, k, v, group=None, causal: bool = False,
                   scale: Optional[float] = None, dropout_rate: float = 0.0,
                   seed_words=None, batch_base: int = 0,
                   head_base: int = 0):
    """Ring attention over a sequence sharded across ``group`` (the sp
    process group; None or one rank: one flash call): ``q, k, v`` are
    this rank's shards ``[B, S/sp, H, D]``, rank ``r`` holding positions
    ``r * S/sp ..``; returns this rank's output shard in q's dtype.
    ``batch_base`` / ``head_base`` are the global index of the first
    batch row and head (the dropout mask's)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _lone(group):
        return flash_attention(q, k, v, causal, scale, dropout_rate,
                               seed_words, batch_base=batch_base,
                               head_base=head_base)
    return _Ring.apply(q, k, v, group, bool(causal), float(scale),
                       float(dropout_rate), seed_words, int(batch_base),
                       int(head_base))


def _alltoall(blocks, group):
    from ..distributed.collective import alltoall
    t0 = time.perf_counter()
    out = alltoall(blocks, group=group)
    RING_STATS["alltoalls"] += 1
    RING_STATS["alltoall_s"] += time.perf_counter() - t0
    return out


def _seq_to_heads(x, group):
    """``[B, S/n, H, D]`` -> ``[B, S, H/n, D]``: rank j's heads block j
    of every rank's positions."""
    n = group.nranks
    B, s, H, D = x.shape
    blocks = x.reshape(B, s, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = _alltoall(blocks.contiguous(), group)       # [n, B, s, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * s, H // n, D)


def _heads_to_seq(y, group):
    """``[B, S, H/n, D]`` -> ``[B, S/n, H, D]``: the inverse."""
    n = group.nranks
    B, S, h, D = y.shape
    blocks = y.reshape(B, n, S // n, h, D).permute(1, 0, 2, 3, 4)
    got = _alltoall(blocks.contiguous(), group)       # [n, B, S/n, h, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _heads_to_seq(y, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group), None


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      scale: Optional[float] = None,
                      dropout_rate: float = 0.0, seed_words=None,
                      batch_base: int = 0, head_base: int = 0):
    """Ulysses sequence parallelism over ``group``: all-to-all from
    sequence to heads, the flash kernels on the whole sequence over
    ``H/sp`` heads (rank ``r``'s from head ``head_base + r * H/sp``),
    all-to-all back. ``q, k, v`` are this rank's shards ``[B, S/sp, H,
    D]`` with ``H % sp == 0``."""
    if _lone(group):
        return flash_attention(q, k, v, causal, scale, dropout_rate,
                               seed_words, batch_base=batch_base,
                               head_base=head_base)
    n, H = group.nranks, q.shape[2]
    if H % n:
        raise ValueError(f"Ulysses attention needs the heads ({H}) to "
                         f"divide over the sp group ({n} ranks)")
    qf, kf, vf = (_SeqToHeads.apply(t, group) for t in (q, k, v))
    of = flash_attention(qf, kf, vf, causal, scale, dropout_rate,
                         seed_words, batch_base=batch_base,
                         head_base=head_base + group.rank * (H // n))
    return _HeadsToSeq.apply(of.contiguous(), group)
